"""Tiling rules of the tensor-core weight stream (csrc/weight_stream.cuh),
shared by the int8_matmul and ffn_tail wrappers. Pure Python: the CPU tests
check the rules, the card runs them.

A CTA owns C = 16 cw columns of the weight(s) and all m rows of the x
operand(s); its 8 warps split as cw column tiles by 8 / cw row sets, each
warp holding at most NG (1, 2 or 4) n8 row groups in registers. A ring
stage holds 64 K rows of each weight and of each x operand.
"""
from __future__ import annotations

SMS = 132                  # the H100's streaming multiprocessors
STAGE_K = 64               # K rows a ring stage (kWsK)
X_ROW = STAGE_K + 8        # bf16 a staged x row (kWsXRow)
MAX_SMEM = 232448          # a block's opt-in shared memory on the H100
SM_SMEM = 233472           # an SM's shared memory for blocks (228 KB)
BLOCK_RESERVE = 1024       # the runtime's shared memory a block
RING_BUDGET = 200 * 1024   # a 4-stage ring of one CTA an SM
CWS = (8, 4, 2, 1)         # m16 column tiles a CTA, widest first
NGS = (1, 2, 4)            # n8 row groups a warp (the kernels' instances)


def row_bytes(cols: int, itemsize: int) -> int:
    """Bytes of a staged weight row (ws_row_bytes): padded to an odd
    number of 16-byte slots."""
    b = cols * itemsize
    return b + (16 if (b // 16) % 2 == 0 else 32)


def stage_bytes(itemsize: int, n_w: int, n_x: int, cw: int, m: int) -> int:
    """Bytes of one ring stage (ws_stage_bytes)."""
    rows = -(-m // 8) * 8
    return (n_w * STAGE_K * row_bytes(16 * cw, itemsize)
            + n_x * rows * X_ROW * 2)


def row_groups(m: int, cw: int) -> int | None:
    """The NG instance holding m rows at cw column tiles, None past 4."""
    need = -(-(-(-m // 8)) // (8 // cw))
    return next((ng for ng in NGS if ng >= need), None)


def tile(m: int) -> tuple[int, int]:
    """(cw, NG): the widest column tile whose warps hold m rows (m <= 256
    always fits cw 1)."""
    return next((cw, ng) for cw in CWS
                if (ng := row_groups(m, cw)) is not None)


def per_sm(smem: int) -> int:
    """CTAs an SM holds by shared memory, at most 4 (the kernels' registers
    allow about that many)."""
    return max(1, min(4, SM_SMEM // (smem + BLOCK_RESERVE)))


def ring(itemsize: int, n_w: int, n_x: int, cw: int, m: int,
         ng: int) -> tuple[int, int] | None:
    """(stages, NG) of the ring: 4 stages, or 3 when that puts more CTAs
    on an SM (one row group a warp: the kernels' 3-stage instance has NG
    1), within RING_BUDGET; else 2 (the 2-stage instance has NG 4); None
    when 2 do not fit."""
    st = stage_bytes(itemsize, n_w, n_x, cw, m)
    if 4 * st <= RING_BUDGET:
        if ng == 1 and per_sm(3 * st) > per_sm(4 * st):
            return 3, 1
        return 4, ng
    if 2 * st <= MAX_SMEM:
        return 2, 4
    return None


def wave(smem: int) -> int:
    """CTAs of one wave: the SMs times per_sm."""
    return SMS * per_sm(smem)


def k_slice(k: int, n_tiles: int, min_rows: int, slots: int) -> int:
    """K rows a slice: as many slices as keep n_tiles column tiles within
    `slots` CTAs (one wave: a second, part-filled one would cost its whole
    time), each slice at least min_rows long, in whole stages."""
    ns = max(1, min(slots // n_tiles, k // min_rows))
    return -(-(-(-k // ns)) // STAGE_K) * STAGE_K
