"""Host dispatch: device operations (kernels, copies, fills) a sparse
step, from the trace."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["unit"] != "rows" or tr is None or tr.steps == 0:
        return None
    return tr.launches / tr.steps
