"""What the matrix-unit microbenchmarks (``mxu_tiles``, ``mxu_parts``,
``mxu_pltd``; kernels in ``csrc/mxu_micro.cu``) share: the shapes, the
plain versions of the dot and of the Möller–Trumbore epilogue, the tile
loop of the rows layout, the data draws, the gates that hold the
tensor-core kernels to their plain versions, the input checks and the
measurement on the card.

The TPU scripts test 256 rays against tiles of 128 triangles as one
product: rays [B, 256, 8] x a tile's panel [8, 768] = out [256, 768], six
blocks of 128 columns (den, num, b1, c1, b2, c2), then t = num / den,
u = b1 + t c1, v = b2 + t c2 and the test.  The plain versions form the
dot as an explicit sum over k = 0..7 in float32, each product and sum
rounded on its own (no ``torch.matmul``, so no TF32 flag can change it;
a NumPy oracle reproduces it bit for bit), and the epilogue in the
scripts' order.  The kernels' f32 dot is 3xTF32 on the tensor cores and
their bf16 dot a bf16 tensor-core product, whose float32 accumulation
rounds otherwise: ``compare`` holds them to the plain versions under
MXU_GATE and BF16_GATE, relative to the magnitude of each result's terms
(den cancels, so a plain relative tolerance on t means nothing where
|den| is small).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _visit

R = 256                   # rays of a grid step
NT = 128                  # triangles (lanes) of a tile
COLS = 6 * NT             # a panel's columns: den, num, b1, c1, b2, c2
K = 8                     # the dot's depth
EPS = float(np.float32(1e-8))
FAR = 1e30                # the scripts' tmax
INF = float("inf")
# The parts whose output uses only den (bt = min(bt, den), bk stays -1);
# the kernels fold the other five blocks into chk (csrc/mxu_micro.cu).
DEAD = ("dotonly", "dotbf16", "bigdot")
CHK_GROUPS = 4            # chk's lane groups: lanes 32 q .. 32 q + 31
SCALE_BLOCKS = 16         # blocks pair_scale gathers at a time

# The kernels against their plain versions.  f32 dots (3xTF32): the best
# tile k equal on all but a fraction k_frac of the (ray, lane) pairs; t,
# where k agrees, within t_rel of |t| (S_num / |num| + S_den / |den|), S
# the sum of the magnitudes of the dot's 8 products (a dot's rounding is
# relative to S); dotonly's and bigdot's min of den within t_rel of the
# largest S_den over the tiles; chk within chk_rel of the sum of the S of
# its terms.  bf16 (dotbf16): the same with BF16_GATE.  Measured on an
# H100 (PERF.md §6), every data set of chip_smoke.py phase 10: k
# differed on at most 2 of a whole C1 case's 16,777,216 pairs and on none
# of the small checks' 131,072 or 163,840 (the gate allows 16 and 0),
# t_rel at most 2.55e-7 (dotonly and bigdot 4.59e-7), chk_rel 2.28e-8;
# bf16 t_rel 2.33e-7, chk_rel 2.32e-8.
MXU_GATE = dict(k_frac=1e-6, t_rel=2e-6, chk_rel=5e-7)
BF16_GATE = dict(t_rel=1e-6, chk_rel=5e-7)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back: bf16 x bf16 products
    are exact in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def dot_plain(a: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
    """a [..., M, 8] x pan [..., 8, N] as an explicit sum over k = 0..7 in
    float32, each product and sum rounded on its own: [..., M, N]."""
    s = a[..., :, 0, None] * pan[..., None, 0, :]
    for k in range(1, K):
        s = s + a[..., :, k, None] * pan[..., None, k, :]
    return s


def dot_bf16_plain(a: torch.Tensor, pan: torch.Tensor) -> torch.Tensor:
    """``dot_plain`` of the operands rounded to bf16."""
    return dot_plain(bf16_round(a), bf16_round(pan))


def coef_blocks(out: torch.Tensor) -> list:
    """The six coefficient blocks of out [..., 768]: den, num, b1, c1, b2, c2."""
    return [out[..., i * NT:(i + 1) * NT] for i in range(6)]


def epilogue_plain(den, num, b1, c1, b2, c2, tmax, bt, bk, kt: int, live=None):
    """The scripts' epilogue of tile kt (``tpu_mxu_pallas_micro2.py:39``):
    (bt, bk) updated where the test passes with t strictly below bt (the
    first tile wins ties) and, where ``live`` is given, the tile is live."""
    t = num / den
    u = b1 + t * c1
    v = b2 + t * c2
    ok = ((den.abs() >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= EPS) & (t < tmax))
    tc = torch.where(ok, t, INF)
    w = tc < bt
    if live is not None:
        w = w & live
    return torch.where(w, tc, bt), torch.where(w, kt, bk)


def rows_plain(rays, rows, tmax, mode: str, trips=None):
    """The rows layout's tile loop (C1 and C2): rays [B, 256, 8], rows [B,
    nt, 8, 768], tmax [B, 256, 128]; mode ``epi`` (the test, every tile or,
    with ``trips``, the first min(trips[p], nt) of block p), ``epionly``
    (no dot: out[r, c] = panel[r % 8, c]), or one of DEAD (bt = min(bt,
    den), ``dotbf16`` on bf16-rounded operands; ``bigdot`` forms one dot
    over the tiles' panels side by side).  Returns (bt, bk, chk): chk
    [B, 256, 4] (DEAD only, else None) sums the dead blocks' values over
    tiles, blocks 1-5 and lanes 32 q .. 32 q + 31, in float64."""
    n_blocks, nt = rows.shape[:2]
    bt = torch.full((n_blocks, R, NT), INF, dtype=torch.float32, device=rays.device)
    bk = torch.full((n_blocks, R, NT), -1, dtype=torch.int32, device=rays.device)
    dead = (torch.zeros(n_blocks, R, COLS - NT, dtype=torch.float64, device=rays.device)
            if mode in DEAD else None)
    trip = None if trips is None else trips.clamp(max=nt)
    if mode == "bigdot":
        wide = dot_plain(rays, rows.permute(0, 2, 1, 3).reshape(n_blocks, K, nt * COLS))
        tiles = [wide[..., kt * COLS:(kt + 1) * COLS] for kt in range(nt)]
    for kt in range(nt):
        pan = rows[:, kt]
        if mode == "bigdot":
            out = tiles[kt]
        elif mode == "epionly":
            out = pan.repeat(1, R // K, 1)
        elif mode == "dotbf16":
            out = dot_bf16_plain(rays, pan)
        else:
            out = dot_plain(rays, pan)
        if dead is not None:
            bt = torch.minimum(bt, out[..., :NT])
            dead += out[..., NT:].double()
        else:
            live = None if trip is None else (kt < trip)[:, None, None]
            bt, bk = epilogue_plain(*coef_blocks(out), tmax, bt, bk, kt, live)
    chk = None
    if dead is not None:
        chk = dead.view(n_blocks, R, 5, CHK_GROUPS, NT // CHK_GROUPS).sum((2, 4)).float()
    return bt, bk, chk


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

CHUNK = 1 << 22           # normals drawn at a time


def normals(rng, shape, blocks=None, tiles=None) -> np.ndarray:
    """``rng.normal(size=shape).astype(np.float32)`` as the scripts draw it,
    advancing rng past the whole array, but kept (and drawn in float64)
    only as far as its first ``blocks`` entries along axis 0; with
    ``tiles``, axis 1 cut to its first ``tiles``.  Normals drawn in chunks
    are the normals of one draw."""
    keep = shape[0] if blocks is None else blocks
    per = int(np.prod(shape[1:]))
    out = rng.normal(size=(keep,) + tuple(shape[1:])).astype(np.float32)
    rest = (shape[0] - keep) * per
    while rest > 0:
        n = min(rest, CHUNK)
        rng.normal(size=n)
        rest -= n
    return out if tiles is None else np.ascontiguousarray(out[:, :tiles])


_STATES: dict = {}


def rng_after(*shapes) -> np.random.Generator:
    """``default_rng(0)`` advanced past normal draws of ``shapes``, made and
    discarded in order (a script's earlier arrays); each advanced state is
    kept, so a later call skips only what it has not skipped before."""
    if shapes not in _STATES:
        rng = rng_after(*shapes[:-1]) if shapes else np.random.default_rng(0)
        if shapes:
            normals(rng, shapes[-1], 0)
        _STATES[shapes] = rng.bit_generator.state
    bits = np.random.PCG64()
    bits.state = _STATES[shapes]
    return np.random.Generator(bits)


def tmax_near(bt: torch.Tensor, seed: int) -> torch.Tensor:
    """A finite tmax [like bt] drawn near each pair's best hit: bt x U(0.5,
    1.5) where bt is finite (half the hits fall behind it), 4 |N(0, 1)|
    elsewhere, from ``default_rng(seed)``, as float32."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, bt.shape).astype(np.float32)
    other = (4.0 * np.abs(rng.normal(size=bt.shape))).astype(np.float32)
    b = bt.cpu().numpy()
    return torch.from_numpy(np.where(np.isfinite(b), b * scale, other).astype(np.float32))


# --------------------------------------------------------------------------
# The wrapper's checks and launch
# --------------------------------------------------------------------------

def check(rays, rows, tmax, rays_shape, tmax_shape, trips=None) -> None:
    """Raises ValueError unless rays, rows [B >= 1, nt >= 1, 8, 768] and
    tmax are contiguous 16-byte aligned float32 tensors of the shapes given
    (rays_shape, tmax_shape: B, then the rest) on one device, and trips,
    where given, a contiguous int32 [B] there too."""
    n_blocks = rows.shape[0] if rows.dim() == 4 else -1
    if rows.dim() != 4 or n_blocks < 1 or rows.shape[1] < 1 or rows.shape[2:] != (K, COLS):
        raise ValueError(f"rows must be [B >= 1, ntiles >= 1, {K}, {COLS}]")
    named = (("rays", rays, (n_blocks, *rays_shape)), ("rows", rows, tuple(rows.shape)),
             ("tmax", tmax, (n_blocks, *tmax_shape)))
    for what, x, shape in named:
        if tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous {list(shape)} float32")
        if x.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
        if x.device != rows.device:
            raise ValueError(f"{what} and rows lie on different devices")
    if trips is not None:
        if tuple(trips.shape) != (n_blocks,) or trips.dtype != torch.int32 \
                or not trips.is_contiguous():
            raise ValueError(f"trips must be contiguous [{n_blocks}] int32")
        if trips.device != rows.device:
            raise ValueError("trips and rows lie on different devices")


def need_tiles(rows, allowed, what: str) -> None:
    """Raises ValueError unless the kernel has an entry point for rows'
    tile count."""
    if rows.shape[1] not in allowed:
        raise ValueError(f"{what}'s kernel takes {allowed} tiles a block, not {rows.shape[1]}")


def launch(name: str, launches: dict, rays, rows, tmax, trips=None, dead=False):
    """Entry point ``name`` of the rows layout on the current stream: (t,
    k, chk) as fresh tensors shaped like tmax (chk [B, 256, 4] where
    ``dead``, else None)."""
    dev = rows.device
    t = torch.empty_like(tmax)
    k = torch.empty(tmax.shape, dtype=torch.int32, device=dev)
    chk = (torch.empty(rows.shape[0], R, CHK_GROUPS, dtype=torch.float32, device=dev)
           if dead else None)
    _visit.launch(name, launches, dev, trips, rays, rows, tmax, rows.shape[0], t, k, chk)
    return t, k, chk


# --------------------------------------------------------------------------
# Gates
# --------------------------------------------------------------------------

def _abs_dot(a, pan):
    """Σ_k |a_k| |pan_k| in float64: [..., M, N]."""
    return torch.matmul(a.double().abs(), pan.double().abs())


def pair_scale(rays, rows, bk) -> torch.Tensor:
    """[B, 256, 128] float64: |t| (S_num / |num| + S_den / |den|) of each
    pair's best tile bk (0 where bk < 0), with num, den and their terms'
    magnitudes S in float64 (rows layout)."""
    out = torch.zeros(bk.shape, dtype=torch.float64, device=bk.device)
    lane = torch.arange(NT, device=bk.device)
    for b0 in range(0, bk.shape[0], SCALE_BLOCKS):
        b1 = min(b0 + SCALE_BLOCKS, bk.shape[0])
        kk = bk[b0:b1].clamp(min=0).long()
        b_idx = torch.arange(b0, b1, device=bk.device)[:, None, None]
        a = rays[b0:b1].double()[:, :, None, :]                    # [b, R, 1, 8]
        d = rows[b_idx, kk, :, lane].double()                      # [b, R, 128, 8]
        n = rows[b_idx, kk, :, NT + lane].double()
        den, num = (a * d).sum(-1), (a * n).sum(-1)
        s_den, s_num = (a.abs() * d.abs()).sum(-1), (a.abs() * n.abs()).sum(-1)
        scale = (num / den).abs() * (s_num / num.abs() + s_den / den.abs())
        out[b0:b1] = torch.where(bk[b0:b1] >= 0, scale, 0.0)
    return out


def den_scale(rays, rows, bf16=False) -> torch.Tensor:
    """[B, 256, 128] float64: the largest S_den over the tiles (of the
    bf16-rounded operands with ``bf16``)."""
    a = bf16_round(rays) if bf16 else rays
    p = bf16_round(rows[..., :NT]) if bf16 else rows[..., :NT]
    return torch.stack([_abs_dot(a, p[:, kt]) for kt in range(rows.shape[1])]).amax(0)


def chk_scale(rays, rows, bf16=False) -> torch.Tensor:
    """[B, 256, 4] float64: the sum of S over chk's terms."""
    a = bf16_round(rays) if bf16 else rays
    p = (bf16_round(rows) if bf16 else rows)[..., NT:].double().abs()
    w = p.sum(1).view(rows.shape[0], K, 5, CHK_GROUPS, NT // CHK_GROUPS).sum((2, 4))
    return torch.matmul(a.double().abs(), w)


def compare(got, want, rays, rows, mode: str) -> dict:
    """Kernel (got) against plain (want) outputs (t, k, chk) of the rows
    layout on inputs rays, rows: ``exact`` (epionly: bit for bit), ``epi``
    (MXU_GATE on k and t), or one of DEAD (bk -1 on both, the min of den
    and, where both have it, chk within the mode's gate).  Returns k_pairs (pairs whose k
    differs), t_rel (the largest error over its scale), chk_rel,
    max_abs_err (|dt| where k agrees and t is finite) and ok."""
    t_g, k_g, t_w, k_w = got[0], got[1], want[0], want[1]
    same = k_g == k_w
    fin = same & torch.isfinite(t_w)
    diff = (t_g - t_w).abs()
    res = dict(k_pairs=int((~same).sum()), t_rel=0.0, chk_rel=0.0,
               max_abs_err=float(diff[fin].max()) if bool(fin.any()) else 0.0)
    if mode == "exact":
        res["ok"] = all(torch.equal(x, y) for x, y in zip(got[:2], want[:2]))
        return res
    bf16 = mode == "dotbf16"
    gate = BF16_GATE if bf16 else MXU_GATE
    if mode in DEAD:
        scale = den_scale(rays, rows, bf16)
        res["t_rel"] = float((diff.double() / scale).max())
        if got[2] is not None and want[2] is not None:
            cs = chk_scale(rays, rows, bf16)
            res["chk_rel"] = float(((got[2] - want[2]).abs().double() / cs).max())
        res["ok"] = (res["k_pairs"] == 0 and bool((k_g == -1).all())
                     and res["t_rel"] <= gate["t_rel"] and res["chk_rel"] <= gate["chk_rel"])
        return res
    scale = pair_scale(rays, rows, torch.where(same, k_w, -1))
    hit = same & (k_w >= 0)
    res["t_rel"] = float((diff.double()[hit] / scale[hit]).max()) if bool(hit.any()) else 0.0
    miss_equal = bool((t_g[same & (k_w < 0)] == INF).all())
    res["ok"] = (res["k_pairs"] <= gate["k_frac"] * k_w.numel() and miss_equal
                 and res["t_rel"] <= gate["t_rel"])
    return res


def require(res: dict, what: str) -> None:
    """Raises ValueError unless ``compare``'s gate held."""
    if not res["ok"]:
        raise ValueError(f"{what}: kernel departs from its plain version beyond its gate: {res}")


# --------------------------------------------------------------------------
# The measurement
# --------------------------------------------------------------------------

def library_ms(lhs: torch.Tensor, rhs: torch.Tensor, bf16: bool) -> dict:
    """The dot alone as one ``torch.bmm`` of lhs [B, M, 8] x rhs [B, 8, N]
    (the port never calls it): the least ms of 3 calls in float32 without
    and with TF32, and in bf16 (operands and output) where ``bf16``."""
    flag = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for name, tf32 in (("f32", False), ("tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out[name] = _visit.least_ms(lambda: torch.bmm(lhs, rhs))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    if bf16:
        lb, rb = lhs.bfloat16(), rhs.bfloat16()
        out["bf16"] = _visit.least_ms(lambda: torch.bmm(lb, rb))
    return out


def measure(name: str, launches: dict, kernel, plain, compare, sets: dict, lib, n_tiles: int,
            n_bytes: int, say=print) -> dict:
    """One entry point on the card: ``kernel(d)`` against ``plain(d)`` by
    ``compare(got, want, d)`` (else ValueError) on each data set d of
    ``sets``; then, with the launch counts reset, on ``sets["whole"]`` (the
    script's size) the kernel's ms (the least of 3 single calls, as the
    other phases of ``chip_smoke.py`` time a call) and its launches there,
    one plain call's ms there and the dot alone (``library_ms(*lib)``,
    none where ``lib`` is None).  Returns those with
    the work (tiles, tests, bytes), ps a test and the largest |dt| of the
    checks; prints a line."""
    checks = {}
    for label, d in sets.items():
        checks[label] = compare(kernel(d), plain(d), d)
        require(checks[label], f"{name} on the {label} data")
    whole = sets["whole"]
    for k in launches:
        launches[k] = 0
    ms = _visit.least_ms(lambda: kernel(whole))
    n_launches = launches[name]
    plain_ms = _visit.least_ms(lambda: plain(whole), calls=1)
    lib = library_ms(*lib) if lib else {}
    tests = n_tiles * R * NT
    ps = ms * 1e9 / tests
    say(f"[{name}] " + "; ".join(
        f"{d}: k differs on {c['k_pairs']}, t_rel {c['t_rel']:.3g}, chk_rel {c['chk_rel']:.3g}"
        for d, c in checks.items())
        + f"; kernel {ms:.4f} ms ({ps:.3f} ps/test), plain {plain_ms:.2f} ms, "
        f"library (the dot alone) {lib}, {n_launches} launches")
    return dict(ms=ms, plain_ms=plain_ms, library=lib, launches=n_launches,
                max_abs_err=max(c["max_abs_err"] for c in checks.values()), checks=checks,
                tiles=n_tiles, tests=tests, bytes=n_bytes, ps_per_test=ps)
