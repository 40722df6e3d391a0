"""The optimizer state: the bytes of every tensor of the program's
optimizer state on the device, in GiB (exact)."""


def read(ctx):
    return ctx["opt_state_bytes"] / float(1 << 30)
