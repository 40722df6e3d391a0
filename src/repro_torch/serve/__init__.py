"""Serve-time adaptation steps of the port."""
