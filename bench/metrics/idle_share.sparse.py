"""The device's idle share of the sparse step: one minus its busy time a step
in the traced steps (the union of its operations) over the unprofiled
window's step time, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None or tr.steps == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.steps / ctx["step_s"])
