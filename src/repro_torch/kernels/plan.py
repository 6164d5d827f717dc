"""Launch plans of the kernels with runtime knobs: K2's split, K4's row
tiling and K6's column tiles, as pure functions of the shapes, the card's
SM count and the knob; and the fixed design of K4b's wgmma kernels (their
tiles, shared memory and persistent walk), which the C side computes for
itself.

The wrappers (``decode_attention.py``, ``moe_gmm.py``, ``rwkv6_scan.py``)
launch with these plans, and the tuner's feasibility (``tune/space.py``)
prices a design point with the same functions, so a point is checked
against the plan it launches.  Nothing here imports ``torch``: the tuner
enumerates its spaces without it.  The constants repeat what each
``csrc/*.cu`` fixes at compile time; the launch limits are
``hw/specs.py``'s.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw.specs import H100_SXM

# ---------------------------------------------------------------------------
# K2, csrc/decode_attention.cu
# ---------------------------------------------------------------------------

DECODE_THREADS = 128  # kThreads: per block of the split pass
TILE = 32  # cache slots per tile (kTile in the source); a split is whole tiles
WAVES = 2  # blocks to aim for, in multiples of the SM count
MAX_GROUP = 16  # query heads per KV head (kMaxG in the source)


def split_plan(B: int, Hkv: int, S: int, n_sm: int, waves: int = WAVES) -> tuple[int, int]:
    """``(n_split, chunk)``: split each (batch row, KV head)'s S slots into
    ``n_split`` ranges of ``chunk`` slots (the last one shorter), ``chunk`` a
    multiple of TILE, so that ``B * Hkv * n_split >= waves * n_sm`` where S
    has enough tiles for it."""
    if waves < 1:
        raise ValueError(f"decode_attention: waves {waves} < 1")
    tiles = -(-S // TILE)
    want = -(-waves * n_sm // (B * Hkv))
    per = max(1, tiles // want)  # tiles per range
    return -(-tiles // per), per * TILE


def split_smem(D: int, chunk: int, itemsize: int, tensor_cores: bool) -> int:
    """Dynamic shared memory of one split-pass block: ``decode_split_mma``'s
    (Q, 4 warps' 3-stage K / V rings or their merge buffer, m / l) or
    ``decode_split_kernel``'s (the K / V ring, scores, m / l / corr, the P V
    step's sums), then one live flag a slot of the range, as the source
    sizes them."""
    warps, stages = DECODE_THREADS // 32, 3
    if tensor_cores:
        rs = D + 8
        ring = warps * stages * 2 * 16 * rs * 2
        fixed = 16 * rs * 2 + max(ring, warps * 16 * D * 4) + 2 * warps * 16 * 4
    else:
        ept = 4 if D <= 128 else D // 32
        fixed = (2 * stages * TILE * D * itemsize
                 + (MAX_GROUP * TILE + 3 * MAX_GROUP + DECODE_THREADS * ept) * 4)
    return fixed + -(-chunk // 128) * 16


# ---------------------------------------------------------------------------
# K4, csrc/moe_gmm.cu (gmm_mma)
# ---------------------------------------------------------------------------

ROW_TILE = 16         # rows of one mma tile
MAX_ROW_TILES = 8     # the default cap on row tiles a block holds
ROW_TILES_BUILT = 10  # kMaxRowTiles: the gmm_mma<MT> instances the source builds, MT 1-10
BN = 256              # kMmaBN: F columns per block (8 warps of 32)
BK = 64               # kMmaBK: depth of one ring stage along D
STAGES = 4            # kMmaStages: ring depth
PAD = 8               # bf16 of padding per shared-memory row (16 bytes)
GMM_THREADS = 256     # kMmaThreads
BLOCK_SMEM = H100_SXM.smem_block_bytes  # the most shared memory one block can take


@dataclasses.dataclass(frozen=True)
class TilePlan:
    row_tiles: int     # 16-row mma tiles per block
    row_blocks: int    # blocks along C
    bn: int            # F columns per block
    bk: int            # depth of one ring stage
    stages: int        # ring depth
    smem_bytes: int    # dynamic shared memory per block
    grid: tuple[int, int, int]  # (F tiles, row blocks, E), F fastest

    def rows(self, C: int) -> list[range]:
        """The C rows each row block covers."""
        h = ROW_TILE * self.row_tiles
        return [range(b * h, min(C, (b + 1) * h)) for b in range(self.row_blocks)]


def stage_bytes(row_tiles: int) -> int:
    """One ring stage: an x tile (rows x BK) and a w tile (BK x BN), padded."""
    return 2 * (ROW_TILE * row_tiles * (BK + PAD) + BK * (BN + PAD))


def tile_plan(E: int, C: int, F: int, max_row_tiles: int = MAX_ROW_TILES) -> TilePlan:
    """gmm_mma's plan, a pure function of the shapes and the cap: all C rows
    in one block where C <= 16 ``max_row_tiles``, else the fewest row
    blocks of equal height, so every weight element is read from device
    memory once (or once per row block)."""
    if not 1 <= max_row_tiles <= ROW_TILES_BUILT:
        raise ValueError(f"moe_gmm: max_row_tiles {max_row_tiles} not in 1..{ROW_TILES_BUILT}")
    tiles = -(-C // ROW_TILE)
    row_blocks = -(-tiles // max_row_tiles)
    row_tiles = -(-tiles // row_blocks)
    return TilePlan(row_tiles, row_blocks, BN, BK, STAGES, STAGES * stage_bytes(row_tiles),
                    (-(-F // BN), row_blocks, E))


# ---------------------------------------------------------------------------
# K4b's wgmma instances, csrc/moe_gmm_bwd.cu (gmm_dgrad_sm90, gmm_wgrad_sm90)
# ---------------------------------------------------------------------------

# each instance's design: consumer warpgroups (64 output rows each, so a
# tile's rows are 64 x them) and ring stages (kWG, kStages of Design<EPI>)
BWD_DESIGN = {"silu": (3, 3), "gelu": (3, 3), "store": (3, 4)}
BWD_TILE_N = 128                # kTN: output columns of a tile
BWD_TILE_K = 64                 # kTK: depth of a k-tile
BWD_EPILOGUES = tuple(BWD_DESIGN)  # gmm_dgrad_sm90's; gmm_wgrad_sm90 stores


def bwd_tile_m(epilogue: str) -> int:
    """Output rows of a tile of the K4b wgmma instance with ``epilogue``."""
    return 64 * _bwd_design(epilogue)[0]


def bwd_entry_regs(epilogue: str) -> int:
    """The registers a thread that the instance's setmaxnreg exchange
    assumes at entry: the register file over its (warpgroups + 1) x 128
    threads, in steps of 8 (``Design<EPI>::kEntryRegs``)."""
    return 65536 // ((_bwd_design(epilogue)[0] + 1) * 128) // 8 * 8


def _bwd_design(epilogue: str) -> tuple[int, int]:
    if epilogue not in BWD_DESIGN:
        raise ValueError(f"moe_gmm_bwd: epilogue {epilogue!r} not in {BWD_EPILOGUES}")
    return BWD_DESIGN[epilogue]


def bwd_smem(epilogue: str) -> int:
    """Dynamic shared memory of the K4b wgmma instance with ``epilogue`` (one
    of BWD_EPILOGUES), as ``kSm90Smem<EPI>`` sizes it: the ring's k-tiles
    of A and B, the output tile's staging (a1 and a3 for the gated
    epilogues, the output for the store), a full and an empty mbarrier a
    stage and two for the staging buffer, and 1024 bytes to align the
    swizzled tiles."""
    wg, stages = _bwd_design(epilogue)
    tm = 64 * wg
    ring = stages * (tm + BWD_TILE_N) * BWD_TILE_K * 2
    staging = (1 if epilogue == "store" else 2) * tm * BWD_TILE_N * 2
    return ring + staging + 8 * (2 * stages + 2) + 1024


def bwd_walk(E: int, M: int, N: int, n_sm: int,
             epilogue: str = "store") -> list[list[tuple[int, int, int]]]:
    """The persistent walk of a K4b wgmma launch of the instance with
    ``epilogue`` whose output is (E, M, N): for each block of its grid (one
    an SM, at most one a tile), the (expert, first row, first column) of
    the output tiles it computes, in its order.  Block b takes tiles b, b +
    grid, ...; tile t is column tile t % nN of row tile (t // nN) % nM of
    expert t // (nN nM), so the blocks in flight share A's row blocks and
    the expert's B."""
    tm = bwd_tile_m(epilogue)
    n_m, n_n = -(-M // tm), -(-N // BWD_TILE_N)
    tiles = E * n_m * n_n
    grid = min(tiles, n_sm)

    def at(t: int) -> tuple[int, int, int]:
        r = t // n_n
        return r // n_m, r % n_m * tm, t % n_n * BWD_TILE_N

    return [[at(t) for t in range(b, tiles, grid)] for b in range(grid)]


# ---------------------------------------------------------------------------
# K6, csrc/rwkv6_scan.cu
# ---------------------------------------------------------------------------

HEAD_DIMS = (8, 16, 64)  # the K instances the source compiles
KT = 4                # kKT: state rows a thread holds
VT = 4                # kVT: state columns a thread holds
STEPS = 32            # kSteps: time steps per ring stage
SCAN_STAGES = 3       # kStages: ring depth
MAX_THREADS = 256     # kMaxThreads
COLUMN_TILES = (64, 32, 16)  # the columns a block may take, widest first


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    B: int
    H: int
    K: int
    V: int
    kt: int            # state rows a thread holds
    vt: int            # state columns a thread holds
    vb: int            # state columns a block holds
    threads: int       # per block: (K / kt) x (vb / vt)
    steps: int         # time steps per ring stage
    stages: int        # ring depth
    smem_bytes: int    # dynamic shared memory per block
    grid: tuple[int, int]  # (column tiles, B * H)

    def tile(self, block: tuple[int, int], thread: int) -> tuple[int, int, range, list[int]]:
        """(b, h, state rows, state columns) that ``thread`` of ``block``
        holds, as the kernel maps them (columns past V are masked off)."""
        g = self.K // self.kt
        b, h = divmod(block[1], self.H)
        kg, c0 = thread % g, block[0] * self.vb + thread // g * self.vt
        return (b, h, range(kg * self.kt, (kg + 1) * self.kt),
                [c for c in range(c0, c0 + self.vt) if c < self.V])


def column_tiles(K: int) -> list[int]:
    """The widths of COLUMN_TILES that give a block of head dim ``K`` whole
    warps (its shuffles take the full mask), widest first."""
    return [c for c in COLUMN_TILES if K // KT * (c // VT) % 32 == 0]


def scan_plan(B: int, H: int, K: int, V: int, n_sm: int, itemsize: int = 2,
              column_tile: int | None = None) -> ScanPlan:
    """The kernel's plan, a pure function of the shapes: one block per
    (batch, head, tile of vb columns).  ``column_tile`` None: vb the widest
    of :func:`column_tiles` that still gives each of the card's ``n_sm``
    SMs a block (else the narrowest); a value must be one of them.
    ``itemsize`` is r / k / v's element size."""
    if K not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim K={K} not in {HEAD_DIMS}")
    widths = column_tiles(K)
    if column_tile is None:
        vb = next((c for c in widths if B * H * -(-V // c) >= n_sm), widths[-1])
    elif column_tile in widths:
        vb = column_tile
    else:
        raise ValueError(f"rwkv6_scan: column_tile {column_tile} not in {widths} "
                         f"(the widths that give whole warps at K={K})")
    smem = SCAN_STAGES * STEPS * (K * (2 * itemsize + 4) + vb * itemsize)
    return ScanPlan(B, H, K, V, KT, VT, vb, K // KT * (vb // VT), STEPS, SCAN_STAGES, smem,
                    (-(-V // vb), B * H))
