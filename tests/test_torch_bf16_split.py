"""The bf16 leaf-row kernel (``csrc/leaf_rows.cu``
``leaf_rows_bf16_live_kernel``: ``leaf_rows_mt_bf16_closest`` and
``leaf_rows_mt_bf16_carry_closest``) emulated step by step on the CPU and
held ``torch.equal`` to ``leaf_rows_plain(precision="bf16")``, with and
without carry-in:

- live-ray compaction by the start t (t_max, or the carry-in t): live when
  above 1e-5 (NaN is not); dead lanes keep their start values;
- row splits of 1, 16 and 32 rows, merged through the inverted key ~(t
  bits << 32 | position) in a shuffled order of arrival; the last split
  decodes it and recomputes u and v with the record test on the winning
  record;
- the packed arithmetic: each staged row is 4 pairs of records (j, j + 1),
  lanes 0-8 as bf16x2 words with record j in the low half; the ray is
  splatted into both halves; a packed mul, add or sub rounds the exact
  result once (emulated by way of float64 and float32, each rounding step
  innocuous); the reciprocal is an f32 division rounded to bf16; the compares are f32 on the widened halves, record j's update
  before record j + 1's.

The data: the indoor scene's packets, ``leaf_split_data.adversarial``,
``leaf_split_data.bf16_ties`` (equal bf16 t at different positions within
a pair, a row, across rows and across a split boundary), the overflow
sweep, 0-row lists and 1 / 40 / 100% live.  Last, the rounding identity
the packed ops rely on: for bf16 x and y, ``(x.float() op y.float())``
rounded to bf16 is the exact result rounded to nearest even (computed with
``fractions.Fraction``), for +, -, x and 1 / a.  Imports no JAX.
"""

import math
import warnings
from fractions import Fraction

import numpy as np
import pytest
import torch

from surf_tpu_torch.accel import bits
from surf_tpu_torch.accel.leaf_rows import (EPS, REC, SLOT_LANE, TRIS, leaf_rows,
                                            leaf_rows_first_design, leaf_rows_plain,
                                            mt_records_bf16)
from surf_tpu_torch.scene import builtin
from surf_tpu_torch.scene.compile import compile_scene

from leaf_split_data import TIE_GROUPS, adversarial, bf16_pairs, bf16_ties, carry_starts

warnings.filterwarnings("ignore", category=RuntimeWarning)
torch.set_num_threads(1)

CPU = torch.device("cpu")
THREADS = 256        # rays of one slice (leaf_rows_threads_per_block)
IN_RANGE_MAX = 2.0 ** 126
KW = dict(precision="bf16")


# --- the packed arithmetic --------------------------------------------------

def _halves(w: torch.Tensor):
    """bf16x2 words (int32) -> (low, high) widened to float32 (a shift, a
    mask)."""
    u = w.numpy().view(np.uint32)
    return (torch.from_numpy((u << np.uint32(16)).view(np.float32)),
            torch.from_numpy((u & np.uint32(0xFFFF0000)).view(np.float32)))


def _pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors rounded to bf16 (nearest even) into bf16x2 words,
    lo in the low half."""
    lb, hb = (x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
              .astype(np.uint32) for x in (lo, hi))
    return torch.from_numpy(((hb << np.uint32(16)) | lb).view(np.int32))


def _packed(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mul / add / sub.rn.bf16x2: each half's exact result rounded once to
    bf16, by way of float64 and float32 (each step innocuous: 53 >= 2 x 24
    + 2 and 24 >= 2 x 8 + 2)."""
    out = []
    for x, y in zip(_halves(a), _halves(b)):
        x, y = x.double(), y.double()
        out.append({"mul": x * y, "add": x + y, "sub": x - y}[op].float())
    return _pack(*out)


def stage_row(row: torch.Tensor) -> torch.Tensor:
    """A table row [128] -> its staged form [4, 9] int32: pair p holds
    records 2p (low half) and 2p + 1 (high half), lanes 0-8."""
    rec = row.reshape(TRIS, REC)[:, :9]
    return _pack(rec[0::2].contiguous(), rec[1::2].contiguous())


def _splat(x: torch.Tensor) -> torch.Tensor:
    return _pack(x, x)


def pair_poly(w: torch.Tensor, ray):
    """mt_pair_bf16x2 of staged pairs (w [P, 9] int32) against the live rays
    (ray: six [n] int32 splats): (a, u, v, t), each a (lo, hi) pair of
    float32 [P, n].  f = 1 / a is the f32 division rounded to bf16 (the
    in-range path's bits below 2^126, the IEEE division's above)."""
    mul = lambda a, b: _packed("mul", a, b)  # noqa: E731
    add = lambda a, b: _packed("add", a, b)  # noqa: E731
    sub = lambda a, b: _packed("sub", a, b)  # noqa: E731
    shape = (w.shape[0], ray[0].shape[0])
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        w[:, c, None].expand(shape).contiguous() for c in range(9))
    ox, oy, oz, dx, dy, dz = (x[None, :].expand(shape).contiguous() for x in ray)
    hx = sub(mul(dy, e2z), mul(dz, e2y))
    hy = sub(mul(dz, e2x), mul(dx, e2z))
    hz = sub(mul(dx, e2y), mul(dy, e2x))
    a = add(add(mul(e1x, hx), mul(e1y, hy)), mul(e1z, hz))
    a0, a1 = _halves(a)
    one = torch.ones_like(a0)
    f = _pack(one / a0, one / a1)
    sx, sy, sz = sub(ox, v0x), sub(oy, v0y), sub(oz, v0z)
    u = mul(f, add(add(mul(sx, hx), mul(sy, hy)), mul(sz, hz)))
    qx = sub(mul(sy, e1z), mul(sz, e1y))
    qy = sub(mul(sz, e1x), mul(sx, e1z))
    qz = sub(mul(sx, e1y), mul(sy, e1x))
    v = mul(f, add(add(mul(dx, qx), mul(dy, qy)), mul(dz, qz)))
    t = mul(f, add(add(mul(e2x, qx), mul(e2y, qy)), mul(e2z, qz)))
    return _halves(a), _halves(u), _halves(v), _halves(t)


def _update(a, u, v, t, pos, best_t, best_pos):
    hit = ((a.abs() >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= EPS) & (t < best_t))
    return torch.where(hit, t, best_t), torch.where(hit, pos, best_pos)


def split_tests(staged: torch.Tensor, pos0: int, ray, best_t, best_pos):
    """A split's staged rows ([K, 4, 9]) tested in order: the polynomial,
    which does not read best_t, for every pair at once; then per row the
    updates pair by pair, record 2p's before 2p + 1's.  A row in which some
    |a| >= 2^126 is run again from its start with the IEEE division, whose
    bits the CPU division already has."""
    K = staged.shape[0]
    a, u, v, t = pair_poly(staged.reshape(K * 4, 9), ray)
    for k in range(K):
        row_t, row_pos = best_t, best_pos
        wide = torch.zeros_like(best_t, dtype=torch.bool)
        for again in (False, True):
            if again:
                if not bool(wide.any()):
                    break
                best_t = torch.where(wide, row_t, best_t)
                best_pos = torch.where(wide, row_pos, best_pos)
            for p in range(4):
                i = k * 4 + p
                for h in range(2):
                    nt, npos = _update(a[h][i], u[h][i], v[h][i], t[h][i],
                                       pos0 + k * TRIS + 2 * p + h, best_t, best_pos)
                    keep = wide if again else torch.ones_like(wide)
                    best_t = torch.where(keep, nt, best_t)
                    best_pos = torch.where(keep, npos, best_pos)
                wide |= (a[0][i].abs() >= IN_RANGE_MAX) | (a[1][i].abs() >= IN_RANGE_MAX)
    return best_t, best_pos


def _key(t: torch.Tensor, pos: torch.Tensor) -> np.ndarray:
    tb = t.numpy().view(np.uint32).astype(np.uint64)
    return ~((tb << np.uint64(32)) | pos.numpy().astype(np.uint64))


def bf16_split_emulation(table, lists, n_rows, rays, block_rays, carry=None, split_rows=32,
                         order_seed=0):
    """leaf_rows_bf16_live_kernel's decomposition on the CPU: (t, r, u, v)."""
    g = lists.shape[0]
    E = table.shape[0]
    n = rays.shape[1]
    start = (rays[6], torch.full((n,), -1, dtype=torch.int32), torch.zeros(n),
             torch.zeros(n)) if carry is None else carry
    out_t, out_r, out_u, out_v = (x.clone() for x in start)  # dead lanes: start values
    keys = np.zeros(n, np.uint64)
    recs = table.reshape(E, TRIS, REC)
    sids = table.view(torch.int32).reshape(E, TRIS, REC)[..., SLOT_LANE["mt"]]
    staged_rows = torch.stack([stage_row(table[r]) for r in range(E)])   # [E, 4, 9]
    order = np.random.default_rng(order_seed)
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    for p in range(g):
        first = p * block_rays
        count = int(n_rows[p])
        sweep = count < 0
        if sweep:
            count = E
        parts = max(1, -(-count // split_rows))
        t0_all = start[0][first:first + block_rays]
        lanes = first + torch.nonzero(t0_all > EPS)[:, 0]   # rank order = lane order
        for s in range(-(-lanes.numel() // THREADS)):
            ray = lanes[s * THREADS:(s + 1) * THREADS]
            o = [bf(rays[c, ray]) for c in range(6)]
            ray2 = [_splat(x) for x in o]
            t0 = start[0][ray]
            for y in order.permutation(parts):               # splits in any order
                best_t = t0.clone()
                best_pos = torch.full_like(ray, -1)
                pos = torch.arange(y * split_rows, min(count, (y + 1) * split_rows))
                if pos.numel():
                    rows = pos if sweep else lists[p].long()[pos]
                    best_t, best_pos = split_tests(staged_rows[rows], int(pos[0]) * TRIS,
                                                   ray2, best_t, best_pos)
                found = (best_t < t0).numpy()
                idx = ray.numpy()[found]
                keys[idx] = np.maximum(keys[idx], _key(best_t[found], best_pos[found]))
            k = keys[ray.numpy()]
            keys[ray.numpy()] = 0
            hit = torch.from_numpy(k != 0)
            kk = ~k
            t_hit = torch.from_numpy((kk >> np.uint64(32)).astype(np.uint32)
                                     .view(np.int32)).view(torch.float32)
            pos = torch.from_numpy((kk & np.uint64(0xFFFFFFFF)).astype(np.int64))[hit]
            row = pos // TRIS if sweep else lists[p].long()[pos // TRIS]
            j = pos % TRIS
            _, u, v, _ = mt_records_bf16(recs[row, j], [x[hit] for x in o[:3]],
                                         [x[hit] for x in o[3:]])   # the decode
            out_t[ray] = torch.where(hit, t_hit, t0)
            won = ray[hit]
            out_r[won], out_u[won], out_v[won] = sids[row, j], u, v
    assert not keys.any(), "the scratch must be left zero"
    return out_t, out_r, out_u, out_v


def _assert_equal(got, want):
    """torch.equal on the bits (a NaN start t comes back as the same NaN)."""
    for name, g, w in zip("truv", got, want):
        g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{name} differs at {int((g != w).sum())} lanes"


def _round_a(table, lists, n_rows, rays, R, k):
    """A carry-in from a first call over each list's first k rows (sweeps
    there whole), and the rest of the lists: (carry, lists_b, n_rows_b)."""
    n_a = torch.where(n_rows < 0, -1, n_rows.clamp(max=k)).to(torch.int32)
    carry = leaf_rows_plain(table, lists, n_a, rays, R, **KW)
    lists_b = lists[:, k:].contiguous()
    n_b = torch.where(n_rows < 0, 0, (n_rows - k).clamp(min=0)).to(torch.int32)
    return carry, lists_b, n_b


def _check(table, lists, n_rows, rays, R, carry_rows, split_rows, order_seed=0):
    """The emulation against the plain version, without carry or resuming
    after carry_rows rows (then also round A + carry = one call)."""
    if carry_rows is None:
        want = leaf_rows_plain(table, lists, n_rows, rays, R, **KW)
        got = bf16_split_emulation(table, lists, n_rows, rays, R, split_rows=split_rows,
                                   order_seed=order_seed)
        _assert_equal(got, want)
        return want
    carry, lists_b, n_b = _round_a(table, lists, n_rows, rays, R, carry_rows)
    want = leaf_rows_plain(table, lists_b, n_b, rays, R, carry=carry, **KW)
    got = bf16_split_emulation(table, lists_b, n_b, rays, R, carry=carry,
                               split_rows=split_rows, order_seed=order_seed)
    _assert_equal(got, want)
    _assert_equal(want, leaf_rows_plain(table, lists, n_rows, rays, R, **KW))
    return want


# --- the indoor scene's packets ---------------------------------------------

@pytest.fixture(scope="module")
def indoor():
    return compile_scene(builtin.make_indoor_scene(), CPU)


def _indoor_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.ones(n, bool)
    act[512:1024] = False                       # an all-dead packet
    act[1024:] = rng.random(n - 1024) < 0.4     # packets 40% live
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act)


@pytest.mark.parametrize("carry_rows", [None, 8], ids=["no_carry", "carry"])
@pytest.mark.parametrize("mode", ["closest", "sweep"])
def test_emulation_matches_plain_on_indoor_packets(indoor, mode, carry_rows):
    o, d, act = _indoor_rays(3 * 512, seed=5)
    tmax = torch.full((o.shape[0],), 1e30)
    tmax[::97] = 1e-5     # live by the activity mask, dead by the t_max rule
    tmax[5::97] = float("nan")
    rays, lists, n_rows = bits.prepare(indoor.trace, o, d, tmax, act, 512,
                                       cap_rows=8 if mode == "sweep" else 0)
    if mode == "sweep":
        assert (n_rows < 0).any()
    want = _check(indoor.trace.ltab, lists, n_rows, rays, 512, carry_rows, split_rows=16)
    assert (want[1][512:1024] == -1).all() and (want[1] >= 0).any()


# --- adversarial data and the bf16 tie set ----------------------------------

DATA = {"adversarial": adversarial, "ties": bf16_ties}


@pytest.mark.parametrize("carry_rows", [None, 6], ids=["no_carry", "carry"])
@pytest.mark.parametrize("live_share", [0.01, 0.4, 1.0])
@pytest.mark.parametrize("split_rows", [1, 16, 32])
@pytest.mark.parametrize("data", list(DATA))
def test_emulation_matches_plain(data, split_rows, live_share, carry_rows):
    table, lists, n_rows, rays, R = DATA[data](seed=2, live_share=live_share, block_rays=256)
    _check(table, lists, n_rows, rays, R, carry_rows, split_rows, order_seed=split_rows)


def test_carry_liveness_rule():
    """A carry-in start t of 1e-5, 0, NaN or -inf is dead (the lane keeps
    its carry-in values, NaN bits too); +inf and 1.00001e-5 are live."""
    table, lists, n_rows, rays, R = bf16_ties(seed=4, block_rays=256)
    carry, lists_b, n_b = _round_a(table, lists, n_rows, rays, R, 6)
    carry = carry_starts(*carry, seed=4)
    want = leaf_rows_plain(table, lists_b, n_b, rays, R, carry=carry, **KW)
    for k in (1, 16):
        _assert_equal(bf16_split_emulation(table, lists_b, n_b, rays, R, carry=carry,
                                           split_rows=k), want)
    t_in = carry[0]
    dead = ~(t_in > EPS)
    assert dead.any() and torch.isnan(t_in).any() and torch.isinf(t_in).any()
    for x, c in zip(want, carry):
        assert torch.equal(x[dead].view(torch.int32), c[dead].view(torch.int32))
    live_inf = torch.isinf(t_in) & (t_in > 0) & (n_b.repeat_interleave(R) > 0)
    assert (want[1][live_inf] >= 0).any()      # a live +inf start finds hits


def test_tie_data_has_ties_won_by_the_first_position():
    """In every group of bf16_ties many rays get the same bf16 t from both
    planes, and there the first list position wins (list 0: the farther
    plane; list 1, the rows reversed: the closer one where the planes lie
    in two rows); where the t differ the closer wins."""
    table, lists, n_rows, rays, R = bf16_ties(live_share=1.0, block_rays=256)
    _, r, _, _ = leaf_rows_plain(table, lists, n_rows, rays, R, **KW)
    recs = table.reshape(-1, TRIS, REC)
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    o = [rays[c] for c in range(6)]
    for k, (_, far, near) in enumerate(TIE_GROUPS.values()):
        t_far, _, _, ok_far = mt_records_bf16(recs[far], [bf(x) for x in o[:3]],
                                              [bf(x) for x in o[3:]])
        t_near, _, _, ok_near = mt_records_bf16(recs[near], [bf(x) for x in o[:3]],
                                                [bf(x) for x in o[3:]])
        both = ok_far & ok_near & (rays[6] > 2.6)
        tie = both & (t_far == t_near)
        closer = both & (t_near < t_far)
        for lst in (0, 1):
            at = {sid: lists[lst].tolist().index(row) * TRIS + j
                  for sid, (row, j) in ((3000 + k, far), (3100 + k, near))}
            first = min(at, key=at.get)
            assert lst == 0 or (first == 3100 + k) == (far[0] != near[0])
            sel = torch.zeros_like(tie)
            sel[lst * R:(lst + 1) * R] = True
            assert int((tie & sel).sum()) >= 5, f"group {k} list {lst}: too few ties"
            assert (r[tie & sel] == first).all()
            assert (r[closer & sel] == 3100 + k).all() and (closer & sel).any()


def test_staged_pairs_put_record_j_in_the_low_half():
    table = adversarial(seed=1)[0]
    staged = stage_row(table[3])
    recs = table[3].reshape(TRIS, REC)[:, :9].to(torch.bfloat16).float()
    for p in range(TRIS // 2):
        lo, hi = _halves(staged[p])
        assert torch.equal(lo, recs[2 * p]) and torch.equal(hi, recs[2 * p + 1])


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors leaf_rows and leaf_rows_first_design are
    leaf_rows_plain, with and without carry-in."""
    table, lists, n_rows, rays, R = bf16_ties(block_rays=256)
    want = leaf_rows_plain(table, lists, n_rows, rays, R, **KW)
    _assert_equal(leaf_rows(table, lists, n_rows, rays, R, **KW), want)
    _assert_equal(leaf_rows_first_design(table, lists, n_rows, rays, R, **KW), want)
    c = leaf_rows_first_design(table, lists, n_rows, rays, R, carry=want, **KW)
    _assert_equal(c, leaf_rows_plain(table, lists, n_rows, rays, R, carry=want, **KW))
    with pytest.raises(ValueError):
        leaf_rows_first_design(table, lists, n_rows, rays, R, precision="bf16", trim=True)


# --- the rounding identity ----------------------------------------------------

BF16_MAX = (2 - Fraction(1, 128)) * Fraction(2) ** 127


def _exp2_floor(a: Fraction) -> int:
    e = a.numerator.bit_length() - a.denominator.bit_length()
    return e - 1 if a < Fraction(2) ** e else e


def round_bf16(q: Fraction, zero_negative: bool) -> float:
    """The exact value q rounded to the nearest bf16 value, ties to even, as
    a float (+-inf past the largest finite value; a zero result takes the
    sign ``zero_negative`` gives it)."""
    if q == 0:
        return -0.0 if zero_negative else 0.0
    neg = q < 0
    a = -q if neg else q
    ulp = Fraction(2) ** (max(_exp2_floor(a), -126) - 7)
    m = a / ulp
    fl = m.numerator // m.denominator
    rem = m - fl
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and fl % 2):
        fl += 1
    val = fl * ulp
    out = math.inf if val > BF16_MAX else float(val)
    return -out if neg else out


def exact_bf16(op: str, x: float, y: float) -> float:
    """x op y (op one of mul, add, sub, rcp: 1 / x) rounded once, exactly."""
    if op == "rcp":
        if math.isnan(x) or math.isinf(x) or x == 0:
            return 1.0 / x if x != 0 else math.copysign(math.inf, x)
        return round_bf16(1 / Fraction(x), False)
    if op == "sub":
        op, y = "add", -y
    if not (math.isfinite(x) and math.isfinite(y)):
        return x * y if op == "mul" else x + y          # IEEE's rules for inf and NaN
    if op == "mul":
        neg = (math.copysign(1, x) < 0) != (math.copysign(1, y) < 0)
        return round_bf16(Fraction(x) * Fraction(y), neg)
    both_neg = math.copysign(1, x) < 0 and math.copysign(1, y) < 0
    return round_bf16(Fraction(x) + Fraction(y), both_neg and x == 0 and y == 0)


def _bits16(x: torch.Tensor) -> list:
    return x.view(torch.int16).tolist()


@pytest.mark.parametrize("op", ["mul", "add", "sub", "rcp"])
def test_f32_op_rounded_to_bf16_is_the_exact_rounding(op):
    """The fact the packed ops rely on: ``(x.float() op y.float())`` rounded
    to bf16 equals the exact result rounded to nearest even, for every pair
    (subnormals, ties, overflow, +-0, inf, NaN as NaN); the plain version's
    bf16 tensor ops give the same bits; so does the emulated packed op."""
    x, y = bf16_pairs(1500, seed=1 + len(op))
    a, b = x.float(), y.float()
    got = {"mul": a * b, "add": a + b, "sub": a - b,
           "rcp": torch.ones_like(a) / a}[op].to(torch.bfloat16)
    ops = {"mul": x * y, "add": x + y, "sub": x - y, "rcp": torch.ones_like(x) / x}[op]
    want = [exact_bf16(op, p, q) for p, q in zip(a.tolist(), b.tolist())]
    w = torch.tensor(want, dtype=torch.float32).to(torch.bfloat16)
    nan = torch.isnan(w.float())
    assert torch.equal(torch.isnan(got.float()), nan) and torch.equal(torch.isnan(ops.float()),
                                                                      nan)
    assert _bits16(got[~nan]) == _bits16(w[~nan])
    assert _bits16(ops[~nan]) == _bits16(w[~nan])
    assert (w[~nan].float().abs() < 2.0 ** -126).any() and torch.isinf(w.float()).any()
    if op != "rcp":
        xw = x.view(torch.int32)  # the pairs as bf16x2 words
        yw = y.view(torch.int32)
        packed = _packed(op, xw, yw).view(torch.bfloat16)
        assert _bits16(packed[~nan]) == _bits16(w[~nan])
