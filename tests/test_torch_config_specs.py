"""The port's configs spec functions (``repro_torch.configs``) against the
reference's (``repro.configs``): the cell matrix and its skip rule, and,
for every effective (arch, shape) cell, each spec function's tree of
shapes and dtypes: the port's ``meta`` tensors against the reference's
``ShapeDtypeStruct``s (``eval_shape`` of the serve cache), exactly;
``decode_cache_specs`` of every family, the rwkv6 and hybrid caches of
their ``long_500k`` cells included.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as J
from repro_torch import configs as T
from repro_torch.core.partition import leaf_paths

def _flat(tree) -> dict:
    """{path: (shape, dtype name)} of a spec tree of either package."""
    if any(isinstance(x, torch.Tensor) for _, x in leaf_paths(tree)):
        return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for p, x in leaf_paths(tree)}
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_cell_matrix_matches_reference():
    assert list(T.cells()) == list(J.cells())
    assert T.SUBQUADRATIC == J.SUBQUADRATIC
    for arch in J.ARCH_IDS:
        for shape in J.SHAPES:
            assert T.cell_skip(arch, shape) == J.cell_skip(arch, shape)
    assert T.cell_skip("whisper-medium", "long_500k") == \
        J.cell_skip("whisper-medium", "long_500k")


@pytest.mark.parametrize("arch,shape", list(J.cells()))
def test_specs_match_reference(arch, shape):
    cj, ct = J.get(arch), T.get(arch)
    sj, st = J.SHAPES[shape], T.SHAPES[shape]
    for name in ("input_specs", "train_batch_specs", "prefill_batch_specs",
                 "decode_batch_specs"):
        got = getattr(T, name)(ct, st)
        assert all(x.device.type == "meta" for _, x in leaf_paths(got))
        assert _flat(got) == _flat(getattr(J, name)(cj, sj)), name
    assert _flat(T.train_batch_specs(ct, st, sampled_softmax=True)) == \
        _flat(J.train_batch_specs(cj, sj, sampled_softmax=True))
    got = T.decode_cache_specs(ct, st)
    assert _flat(got) == _flat(J.decode_cache_specs(cj, sj))
    if ct.family in ("rwkv6", "hybrid") and shape == "long_500k":
        # O(1) recurrent state; the hybrid's shared block keeps a KV
        # cache of the cell's 524,288 positions at each site
        assert "len" in got and got["len"].dim() == 0
        if ct.family == "hybrid":
            assert got["attn_k"].shape[2] == st.seq_len
    if ct.family == "vlm" and st.kind != "decode":
        # the patches count in the cell's positions
        specs = T.input_specs(ct, st)
        assert specs["patches"].shape[1] + specs["tokens"].shape[1] == \
            st.seq_len
