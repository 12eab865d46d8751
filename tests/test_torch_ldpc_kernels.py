"""The LDPC kernels' host side, on the CPU: their oracles (the plain
min-sum BP and OSD) against the JAX package at every code and OSD shape the
kernels serve beside FT8's (``tests/test_torch_ldpc_osd.py``), the tables
and pattern lists the kernels take, CPU dispatch to the plain versions,
and the wrappers' refusals, which come before any build."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu.modes import ldpc as jldpc
from cwsl_digi_tpu.modes import osd as josd
from cwsl_digi_tpu.modes import wspr as jwspr
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import _kernels, fst4, ft4, ft8, js8, ldpc, osd
from cwsl_digi_tpu_torch.modes import wspr

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _generator(code) -> np.ndarray:
    return np.concatenate([np.eye(code.k, dtype=np.uint8), code.gen_parity],
                          axis=1)


# (name, port code, JAX code, iterations the mode runs)
BP_CODES = [("js8", js8.js8_code, jjs8.js8_code, 30),
            ("fst4", ldpc.fst4_code, jldpc.fst4_code, 60)]


@pytest.mark.parametrize("name,code,jcode,iters", BP_CODES,
                         ids=[c[0] for c in BP_CODES])
def test_bp_plain_matches_jax_on_other_codes(name, code, jcode, iters):
    """JS8's LDPC(174,87) and FST4's (240,101), max_row 6, at the mode's
    iteration count, a quarter of the words rounded (duplicated minima):
    hard and parity_ok identical; post_llr within atol 1e-3 (float32
    min-sum, sums of <= 3 check messages in another order)."""
    c = code()
    np.testing.assert_array_equal(c.h, jcode().h)
    llr = chip_smoke.noisy_llrs(_generator(c), 96, seed=iters + c.n,
                                ties=24)
    jd = jldpc.BPDecoder(jcode(), iters=iters)
    td = ldpc.BPDecoder(c, iters=iters, device="cpu")
    jh, jok, jpost = (np.asarray(x) for x in jd.decode_full(jnp.asarray(llr)))
    th, tok, tpost = td.decode_full(torch.from_numpy(llr))
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(tpost.numpy(), jpost, atol=1e-3)
    assert 0 < jok.sum() < len(jok)       # both converged and failed words


def _osd_shapes():
    """(name, generator [k, n], flip patterns [T, k]) of WSPR's (162, 50)
    code with its 740 patterns and FST4's (240, 101) with FST4-60's."""
    g, _ = wspr._code_matrices()
    cfg = wspr.WSPRConfig()
    spec = fst4.make_spec(Mode.FST4_60)
    c = ldpc.fst4_code()
    return [("wspr", g, osd.flip_patterns(50, cfg.osd_singles,
                                          cfg.osd_tail2, cfg.osd_tail3)),
            ("fst4", _generator(c),
             osd.flip_patterns(c.k, spec.osd_singles, spec.osd_tail2,
                               spec.osd_tail3))]


@pytest.mark.parametrize("shape", [0, 1], ids=["wspr", "fst4"])
def test_osd_plain_matches_jax_on_other_shapes(shape):
    """OSD of WSPR's convolutional code as a (162, 50) block code (740
    patterns, triples over the last 14 positions) and of FST4's (240, 101):
    codeword and hard-error count exact; soft distance within rtol 1e-5
    (float32 dot products in another order); an eighth of the words
    rounded (ties in |LLR|: the stable sort)."""
    name, gen, pats = _osd_shapes()[shape]
    if name == "wspr":
        np.testing.assert_array_equal(gen, jwspr._code_matrices()[0])
        assert pats.shape == (740, 50)
    llr = chip_smoke.noisy_llrs(gen, 48, seed=11 + shape, ties=6)
    pats = pats.astype(np.float32)
    jcw, jdist, jnh = (np.asarray(x) for x in josd.osd_decode(
        jnp.asarray(gen), jnp.asarray(llr), jnp.asarray(pats)))
    tcw, tdist, tnh = osd.osd_decode(torch.from_numpy(gen),
                                     torch.from_numpy(llr),
                                     torch.from_numpy(pats))
    np.testing.assert_array_equal(tcw.numpy(), jcw)
    np.testing.assert_array_equal(tnh.numpy(), jnh)
    np.testing.assert_allclose(tdist.numpy(), jdist, rtol=1e-5)
    cw = tcw.numpy().astype(np.int64)
    np.testing.assert_array_equal((cw @ _parity_checks(gen).T) % 2, 0)


def _parity_checks(gen: np.ndarray) -> np.ndarray:
    """A parity-check matrix of the code ``gen`` generates (its null
    space over GF(2))."""
    k, n = gen.shape
    red, pivots = ldpc.gf2_row_reduce(gen)
    free = [c for c in range(n) if c not in pivots]
    h = np.zeros((len(free), n), np.int64)
    for i, f in enumerate(free):
        h[i, f] = 1
        for r, p in enumerate(pivots):
            h[i, p] = red[r, f]
    return h


def _pattern_tables():
    """Every flip-pattern table the decoders build: FT8/FT4's, JS8's,
    FST4's and WSPR's at each ``wsprcycles`` class."""
    out = {}
    for name, dec in [("ft8", ft8.FT8Decoder(device="cpu")),
                      ("ft4", ft4.FT4Decoder(depth=3, device="cpu")),
                      ("js8", js8.JS8Decoder(device="cpu")),
                      ("fst4", fst4.FST4Decoder(Mode.FST4_60, device="cpu"))]:
        out[name] = (dec._host["patterns"], dec._tabs["pattern_idx"])
    for cycles in (None, 300, 20_000):
        dec = wspr.WSPRDecoder(cycles=cycles, device="cpu")
        out[f"wspr_{cycles}"] = (dec._host["patterns"],
                                 dec._tabs["pattern_idx"])
    return out


def test_pattern_index_lists_rebuild_every_table():
    """The int16 index lists the decoders upload beside each flip-pattern
    table rebuild it exactly, each pattern's coordinates in increasing
    order and -1 padded."""
    tables = _pattern_tables()
    assert tables["ft8"][0].shape == (268, 91)
    assert tables["wspr_None"][0].shape == (740, 50)
    for name, (pats, idx) in tables.items():
        assert idx.dtype == torch.int16 and idx.shape == (len(pats), 3), name
        idx = idx.numpy()
        rebuilt = np.zeros_like(pats)
        for t, row in enumerate(idx):
            real = row[row >= 0]
            assert list(real) == sorted(set(real)), name
            assert (row[len(real):] == -1).all(), name
            rebuilt[t, real] = 1
        np.testing.assert_array_equal(rebuilt, pats, err_msg=name)
        np.testing.assert_array_equal(osd.pattern_index_lists(pats), idx)


@pytest.mark.parametrize("code", [ldpc.ft8_code, js8.js8_code,
                                  ldpc.fst4_code],
                         ids=["ft8", "js8", "fst4"])
def test_bp_kernel_tables_match_build_bp_tables(code):
    """The int16 tables the BP kernel takes are build_bp_tables' row_cols
    (n in a padded slot) and col_slots (-1 where col_mask is 0), and a
    decoder uploads them once."""
    c = code()
    t = ldpc.build_bp_tables(c.h)
    rc, cs = ldpc.kernel_tables(t)
    assert rc.dtype == cs.dtype == np.int16
    np.testing.assert_array_equal(rc, t.row_cols)
    np.testing.assert_array_equal(rc == t.n, t.row_mask == 0)
    np.testing.assert_array_equal(cs[t.col_mask > 0],
                                  t.col_slots[t.col_mask > 0])
    assert (cs[t.col_mask == 0] == -1).all()
    dec = ldpc.BPDecoder(c, device="cpu")
    np.testing.assert_array_equal(dec._k_row_cols.numpy(), rc)
    np.testing.assert_array_equal(dec._k_col_slots.numpy(), cs)


def _bp_model(bp, llr: np.ndarray):
    """bp_minsum in NumPy float32 as the kernel computes it: each check
    forms alpha * m1 and alpha * m2eff (m1 when the minimum is duplicated,
    else the second minimum) once, and each outgoing message from them
    (m2eff where the magnitude is the minimum) and its sign (its own sign
    bit against the parity of all); each variable sums its incoming
    messages in column-slot order from 0.  Returns (hard, ok, post)."""
    f32 = np.float32
    rc, cs = (x.astype(np.int64) for x in ldpc.kernel_tables(bp.t))
    m, n = llr.shape
    nc, mr = rc.shape
    real = rc < n
    col = np.where(real, rc, 0)
    alpha = f32(bp.alpha)
    msg = np.zeros((m, nc, mr), f32)
    tot = llr.copy()
    for _ in range(bp.iters):
        mag = np.full((m, nc, mr), f32(1e9), f32)
        neg = np.zeros((m, nc), np.int64)
        for s in range(mr):
            v = tot[:, col[:, s]] - msg[:, :, s]
            mag[:, :, s] = np.where(real[:, s], np.abs(v), f32(1e9))
            neg |= ((v < 0) & real[:, s]).astype(np.int64) << s
        m1 = mag[:, :, 0]
        for s in range(1, mr):
            m1 = np.fmin(m1, mag[:, :, s])
        m2 = np.full_like(m1, f32(1e9))
        n_min = np.zeros((m, nc), np.int64)
        for s in range(mr):
            m2 = np.where(mag[:, :, s] > m1, np.fmin(m2, mag[:, :, s]), m2)
            n_min += mag[:, :, s] <= m1
        a1 = alpha * m1
        a2 = alpha * np.where(n_min > 1, m1, m2)
        par = np.vectorize(lambda x: bin(x).count("1") & 1)(neg)
        sgn = neg ^ np.where(par == 1, 0xFF, 0)
        for s in range(mr):
            v = np.where(mag[:, :, s] == m1, a2, a1)
            v = np.where((sgn >> s) & 1, -v, v)
            msg[:, :, s] = np.where(real[:, s], v, f32(0))
        inc = np.zeros((m, n), f32)
        flat = msg.reshape(m, nc * mr)
        for e in range(cs.shape[1]):
            sl = cs[:, e]
            inc = np.where(sl >= 0, inc + flat[:, np.maximum(sl, 0)], inc)
        tot = llr + inc
    hard = (tot < 0).astype(np.int8)
    syn = np.zeros((m, nc), np.int64)
    for s in range(mr):
        syn ^= (tot[:, col[:, s]] < 0) & real[:, s]
    return hard, ~syn.any(axis=1), tot


@pytest.mark.parametrize("code,iters", [(ldpc.ft8_code, 30),
                                        (js8.js8_code, 30),
                                        (ldpc.fst4_code, 60)],
                         ids=["ft8", "js8", "fst4"])
def test_bp_kernel_model_equals_plain_bit_for_bit(code, iters):
    """Messages formed from each check's alpha * m1, alpha * m2eff and sign
    mask are the plain min-sum's: the model of the kernel gives
    decode_full_plain's hard bits, parity flags and posterior totals bit
    for bit, on noisy words with a quarter rounded (tied magnitudes,
    duplicated minima), zeros of both signs, and words that do not
    converge."""
    c = code()
    bp = ldpc.BPDecoder(c, iters=iters, device="cpu")
    llr = chip_smoke.noisy_llrs(_generator(c), 48, seed=c.n + iters,
                                ties=12)
    llr[0, :9] = -0.0
    llr[1, ::4] = 0.0
    llr[2, 1::5] = -0.0
    got = _bp_model(bp, llr)
    want = [x.numpy() for x in bp.decode_full_plain(torch.from_numpy(llr))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2].view(np.uint32),
                                  want[2].view(np.uint32))
    assert 0 < want[1].sum() < len(llr)    # converged and failed words


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    """decode_full and osd_decode on CPU tensors return the plain versions'
    results and never reach a kernel wrapper."""
    def kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(_kernels, "bp_minsum", kernel)
    monkeypatch.setattr(_kernels, "osd", kernel)
    before = dict(_kernels.launches)
    dec = ft8.FT8Decoder(device="cpu")
    llr = torch.from_numpy(chip_smoke.noisy_llrs(dec._host["gen"], 16, 3))
    for a, b in zip(dec.bp.decode_full(llr), dec.bp.decode_full_plain(llr)):
        assert torch.equal(a, b)
    tabs = dec._tabs
    got = osd.osd_decode(tabs["gen"], llr, tabs["patterns"],
                         tabs["pattern_idx"])
    want = osd.osd_decode_plain(tabs["gen"], llr, tabs["patterns"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _kernels.launches == before


def test_non_cpu_tensors_never_run_the_plain_versions(monkeypatch):
    """A tensor on any device but the CPU goes to the kernel wrappers,
    which refuse a device that is not CUDA: no fallback."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(ldpc.BPDecoder, "decode_full_plain", plain)
    monkeypatch.setattr(osd, "osd_decode_plain", plain)
    dec = ft8.FT8Decoder(device="cpu")
    llr = torch.zeros((4, 174), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dec.bp.decode_full(llr)
    gen = dec._tabs["gen"].to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        osd.osd_decode(gen, llr, dec._tabs["patterns"].to("meta"),
                       dec._tabs["pattern_idx"].to("meta"))
    with pytest.raises(ValueError, match="pattern_idx"):
        osd.osd_decode(gen, llr, dec._tabs["patterns"].to("meta"))


@pytest.fixture
def no_build(monkeypatch):
    """Every refusal must come before the library is built or loaded."""
    def build():
        raise AssertionError("the library was built")

    monkeypatch.setattr(_kernels, "load_library", build)


def _bp_args():
    dec = ldpc.BPDecoder(ldpc.ft8_code(), device="cpu")
    llr = torch.zeros((8, 174))
    return llr, dec._k_row_cols, dec._k_col_slots


def test_bp_wrapper_refusals(no_build):
    """bp_minsum refuses a CPU tensor, a wrong dtype, a non-contiguous
    input, and a code beyond its limits (n > 256, max_row > 8)."""
    llr, rc, cs = _bp_args()
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.bp_minsum(llr, rc, cs, 30, 0.8)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.bp_minsum(llr.double(), rc, cs, 30, 0.8)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.bp_minsum(llr, rc.int(), cs, 30, 0.8)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.bp_minsum(torch.zeros((174, 8)).T, rc, cs, 30, 0.8)
    with pytest.raises(ValueError, match="n <= 256"):
        _kernels.bp_minsum(torch.zeros((8, 300)), rc,
                           torch.zeros((300, 3), dtype=torch.int16), 30, 0.8)
    with pytest.raises(ValueError, match="max_row <= 8"):
        _kernels.bp_minsum(llr, torch.zeros((83, 9), dtype=torch.int16), cs,
                           30, 0.8)
    with pytest.raises(ValueError, match="max_col <= 4"):
        _kernels.bp_minsum(llr, rc, torch.zeros((174, 5), dtype=torch.int16),
                           30, 0.8)


def _osd_args():
    dec = ft8.FT8Decoder(device="cpu")
    return (dec._tabs["gen"], torch.zeros((8, 174)),
            dec._tabs["pattern_idx"])


def test_osd_wrapper_refusals(no_build):
    """osd refuses a CPU tensor, a wrong dtype, a non-contiguous input, a
    weight-4 pattern, k > 128 and n > 256."""
    gen, llr, idx = _osd_args()
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.osd(gen, llr, idx)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.osd(gen.float(), llr, idx)
    with pytest.raises(ValueError, match="dtype"):
        _kernels.osd(gen, llr.half(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.osd(gen, torch.zeros((174, 8)).T, idx)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.osd(torch.zeros((174, 91), dtype=torch.uint8).T, llr, idx)
    with pytest.raises(ValueError, match="at most 3"):
        _kernels.osd(gen, llr, torch.zeros((10, 4), dtype=torch.int16))
    with pytest.raises(ValueError, match="k <= 128"):
        _kernels.osd(torch.zeros((129, 174), dtype=torch.uint8), llr, idx)
    with pytest.raises(ValueError, match="n <= 256"):
        _kernels.osd(torch.zeros((91, 257), dtype=torch.uint8),
                     torch.zeros((8, 257)), idx)
    pats = np.zeros((3, 20), np.uint8)
    pats[1, [2, 5, 7, 9]] = 1
    with pytest.raises(ValueError, match="weight 4"):
        osd.pattern_index_lists(pats)


def test_importing_the_kernel_module_builds_nothing():
    """A fresh interpreter imports the LDPC kernel module and the decoders
    and decodes on the CPU with every build made to fail: no build, no
    library loaded."""
    code = (
        "from cwsl_digi_tpu_torch import kernel_build\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('built a library')\n"
        "kernel_build.build_library = kernel_build.nvcc = boom\n"
        "import torch\n"
        "from cwsl_digi_tpu_torch.modes import _kernels, ft8, wspr\n"
        "d = ft8.FT8Decoder(top_k=16, device='cpu')\n"
        "d.decode(torch.zeros((1, 180000)))\n"
        "wspr.WSPRDecoder(device='cpu')\n"
        "assert _kernels._lib is None\n"
        "assert _kernels.launches == {'bp_minsum': 0, 'osd': 0}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
