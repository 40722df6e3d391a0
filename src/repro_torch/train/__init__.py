"""Train-step factories of the port."""
