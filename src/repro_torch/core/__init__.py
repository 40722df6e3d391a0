"""Sketch core, stores, transforms and optimizers of the port."""
