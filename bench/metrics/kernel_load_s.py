"""The kernels' build or load: the seconds the program's first call for
its CUDA kernel library took in this run's process, ``nvcc`` included
where it ran (``repro_torch.kernels.build.load_stats``), a part of
``setup_s``; None where the program keeps no such counter or loaded no
library."""


def read(ctx):
    from repro_torch.kernels import build
    stats = getattr(build, "load_stats", None)
    got = stats() if stats is not None else None
    return None if got is None else got["seconds"]
