"""The kernel library's build-or-load counter (``kernels/build.py``:
``library`` keeps what its first call spent, ``load_stats`` returns
it), on the CPU with the build and the loader stubbed."""
from __future__ import annotations

import ctypes

import pytest

from repro_torch.kernels import build


class _Lib:
    def __getattr__(self, name):
        fn = lambda *a: 0  # noqa: E731
        return fn


@pytest.fixture
def fresh(monkeypatch):
    """A process whose library was never loaded; the cache and counter
    are put back as found afterwards."""
    monkeypatch.setattr(build, "_LOAD", {})
    build.library.cache_clear()
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _Lib())
    yield
    build.library.cache_clear()


@pytest.mark.parametrize("nvcc_s", [0.0, 37.5])
def test_load_stats_counts_the_first_call(fresh, monkeypatch, nvcc_s):
    calls = []

    def stub():
        calls.append(1)
        return "libcs_kernels.so", nvcc_s, ""
    monkeypatch.setattr(build, "build", stub)
    assert build.load_stats() is None
    build.library()
    got = build.load_stats()
    assert set(got) == {"seconds", "nvcc"}
    assert got["nvcc"] is (nvcc_s > 0)
    assert 0.0 <= got["seconds"] < 5.0
    build.library()
    assert calls == [1] and build.load_stats() == got
