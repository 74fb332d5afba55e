"""Operations and bytes of one call of each kernel on the serving path,
as (flops by precision, bytes).  Frozen copies of the arithmetic the port
first used for its kernels; they do not follow the program."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

Work = Tuple[Dict[str, float], float]


def causal_pairs(S: int) -> int:
    """(query, key) pairs of causal attention over ``S`` rows."""
    return S * (S + 1) // 2


def flash_attention(S: int, H: int, KV: int, D: int, dbytes: int = 2) -> Work:
    """One batch-1 causal prefill over ``S`` tokens: the multiply-adds of
    q·kᵀ and p·v over the causal pairs; q, k, v read once, out written once."""
    return ({"bf16": 4.0 * H * D * causal_pairs(S)},
            float(S * (2 * H + 2 * KV) * D * dbytes))


def paged_attention(lens: Sequence[int], H: int, KV: int, D: int, page_size: int,
                    dbytes: int = 2) -> Work:
    """One decode call over the live slots' contexts ``lens`` (tokens,
    the new one included): their k/v rows, page-table entries and lengths
    read once, q read and out written once."""
    tokens = sum(lens)
    pages = sum(-(-n // page_size) for n in lens)
    B = len(lens)
    return ({"bf16": 4.0 * tokens * H * D},
            float((2 * tokens * KV * D + 2 * B * H * D) * dbytes + 4 * pages + 4 * B))


def ssm_scan(S: int, H: int, P: int, N: int, chunk: int) -> Work:
    """One batch-1 SSD chunked scan over ``S`` tokens in float32 (on the
    tensor cores: TF32 peak): C·Bᵀ (lower triangle, once per chunk), the
    intra-chunk term, the entering state's term and the state update;
    x, dt, A, B, C read once, y and the final state written once."""
    nc = S / chunk
    tri = chunk * (chunk + 1) / 2
    flops = 2.0 * nc * tri * (N + H * P) + 2 * (2.0 * S * H * P * N)
    nbytes = 4 * (2 * S * H * P + S * H + H + 2 * S * N + H * P * N)
    return {"tf32": flops}, float(nbytes)
