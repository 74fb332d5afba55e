"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with nvcc; without one each test skips (decided
inside the ``cuda`` fixture, never at import).  On a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,S,D,window",
    [
        (1, 4, 2, 16, 32, None),
        (2, 4, 2, 48, 64, None),
        (1, 8, 2, 100, 128, 33),
        (2, 32, 8, 257, 128, None),
        (1, 2, 2, 130, 64, 1),
    ],
)
def test_flash_kernel_matches_plain(cuda, dtype, B, H, KV, S, D, window):
    rng = np.random.default_rng(S)
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, S, KV, D), dtype, cuda)
    v = _randn(rng, (B, S, KV, D), dtype, cuda)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = fa_mod.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 1 / math.sqrt(D), window
    ).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,D,num_pages,page_size,max_pages",
    [
        (2, 4, 2, 64, 8, 16, 3),
        (3, 8, 2, 64, 16, 32, 4),
        (1, 8, 1, 128, 8, 64, 2),
        (2, 4, 4, 32, 12, 8, 6),
        (4, 32, 8, 128, 40, 16, 9),
    ],
)
def test_paged_kernel_matches_plain(cuda, dtype, B, H, KV, D, num_pages, page_size,
                                    max_pages):
    rng = np.random.default_rng(num_pages)
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    pk = _randn(rng, (num_pages, page_size, KV, D), dtype, cuda)
    pv = _randn(rng, (num_pages, page_size, KV, D), dtype, cuda)
    pt = torch.as_tensor(rng.integers(0, num_pages, size=(B, max_pages)),
                         dtype=torch.int32, device=cuda)
    lengths = rng.integers(1, max_pages * page_size + 1, size=B)
    lengths[0] = 0  # an idle slot gives zeros
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, pk, pv, pt, lengths)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    want = paged_mod.paged_decode_attention_plain(q[:, 0], pk, pv, pt, lengths)[:, None]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    assert got[0].abs().max().item() == 0.0


def test_wrappers_raise_on_unsupported_input(cuda):
    q = torch.zeros((1, 16, 4, 48), device=cuda)  # head_dim 48 has no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
