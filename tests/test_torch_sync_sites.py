"""The seven places where the port built a 0-d tensor (or a short list)
on the device from a Python value: on a CUDA device each was a blocking
copy from host memory, a host sync the reference's jitted code does not
make. Each now passes the Python scalar to ``torch.where`` or
``masked_fill``, or builds the list on the device. Here each new
expression is held bit for bit against the old one, on f32 and bf16
inputs (a Python scalar and a 0-d f32 tensor promote alike: the result
keeps the other operand's dtype). That the sites make no sync on the card
is held by tests/test_torch_cuda.py."""

import pytest
import torch

from repro_torch.core import routing
from repro_torch.kernels import ref

DTYPES = {"f32": (torch.float32, torch.int32),
          "bf16": (torch.bfloat16, torch.int16)}


def _inputs(dtype, shape=(3, 4, 5, 6), seed=0):
    """Values of every kind where the scalar is written: normals scaled up
    to 1e6, zeros of both signs, infinities; and a random mask."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 10 ** torch.randint(
        0, 7, shape, generator=g)
    flat = x.view(-1)
    flat[:4] = torch.tensor([0.0, -0.0, float("inf"), float("-inf")])
    mask = torch.rand(shape, generator=g) < 0.5
    return x.to(dtype), mask


def _sites():
    """(old, new) for each site, both functions of (x, mask)."""
    host = torch.tensor
    return {
        # models/attention.py attn_decode: masked decode logits.
        "attn_decode": (lambda x, m: torch.where(m, x, host(-1e30)),
                        lambda x, m: torch.where(m, x, -1e30)),
        # kernels/ref.py attention_ref: masked logits.
        "attention_ref": (lambda x, m: torch.where(m, x, host(ref.NEG_INF)),
                          lambda x, m: torch.where(m, x, ref.NEG_INF)),
        # kernels/ref.py ssd_chunked_ref: segment sums above the diagonal.
        "ssd_chunked_ref": (
            lambda x, m: torch.where(m, x, host(float("-inf"))),
            lambda x, m: torch.where(m, x, float("-inf"))),
        # core/objectives.py design_cost: absent links cost INF.
        "design_cost": (lambda x, m: torch.where(m, x, host(routing.INF)),
                        lambda x, m: torch.where(m, x, routing.INF)),
        # core/objectives.py evaluate_with_tables: INF rows for designs
        # that are not connected.
        "evaluate_with_tables": (
            lambda x, m: torch.where(m, x, host(routing.INF)),
            lambda x, m: torch.where(m, x, routing.INF)),
        # core/routing.py next_hop: staying put is no candidate hop.
        "next_hop": (
            lambda x, m: torch.where(m, host(routing.INF, dtype=x.dtype), x),
            lambda x, m: x.masked_fill(m, routing.INF)),
        # core/fused.py fused_features: the degree update of a link move.
        "fused_features": (
            lambda x, m: host([-1.0, -1.0, 1.0, 1.0], dtype=x.dtype).expand(
                x.shape[0], 4),
            lambda x, m: (torch.arange(4) // 2 * 2 - 1).to(x.dtype).expand(
                x.shape[0], 4)),
    }


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("site", sorted(_sites()))
def test_new_expression_is_the_old_bit_for_bit(site, dtype):
    dt, bits = DTYPES[dtype]
    old, new = _sites()[site]
    x, mask = _inputs(dt)
    want, got = old(x, mask), new(x, mask)
    assert got.dtype == want.dtype == dt
    assert got.shape == want.shape
    assert torch.equal(got.contiguous().view(bits),
                       want.contiguous().view(bits))


def test_the_sites_no_longer_copy_from_the_host():
    """No module of the port builds a device tensor from a Python value in
    these functions any more (``torch.tensor(..., device=...)``)."""
    import inspect

    from repro_torch.core import fused, objectives
    from repro_torch.models import attention
    for fn in (attention.attn_decode, ref.attention_ref, ref.ssd_chunked_ref,
               objectives.design_cost, objectives.evaluate_with_tables,
               routing.next_hop, fused.fused_features):
        assert "torch.tensor(" not in inspect.getsource(fn), fn.__name__
