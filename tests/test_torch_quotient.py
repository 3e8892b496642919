"""The quotient of the port (stark/quotient.py, ops/quotient.py and the
kernels stark/codegen.py generates over csrc/quotient.cuh) on the CPU.

- The plain quotient equals the JAX package's exactly, on seeded LDEs at
  the smallest height that reaches the code (a 2^3-row trace, 16 coset
  rows), in one block and in 4-column blocks: the Cpu chip, the Program
  chip (preprocessed) and the Cpu chip without LogUp (the uni-STARK).
- Each chip's generated body, compiled with g++ with its host loop
  (`zkbf_quotient_host`, the part of csrc/quotient.cuh built without
  __CUDACC__: each tile staged by the kernel's own staging code into a
  host array of the kernel's pitch), equals the plain version bit for bit
  for all 8 chips: on a whole LDE whose next rows wrap, and on a mesh
  shard (row0 > 0) in 4-column blocks, its next rows past its last taken
  from a halo; and at the tile edges (TILE_CASES: several tiles and the
  wrap at the last, a last tile of fewer rows, a shard smaller than a
  tile, runs off a 16-byte boundary, column views with a larger row
  stride and EF4 planes straddling two blocks, a next_step of 4).
- The parameter words (the beta powers and fold weights by
  `ef_host.powers`) equal those of an EF4 product loop.
- The recorded constraints' flags are the chip's `constraint_ext_flags`,
  and recording a chip twice gives the same text and hash.
- On CPU tensors the wrapper runs the plain version and counts no launch.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sharded import one_torch_thread  # noqa: F401 (autouse)

from zkvm_brainfuck_tpu.models.machine_def import brainfuck_chips as jax_chips
from zkvm_brainfuck_tpu.ops import field as jf
from zkvm_brainfuck_tpu.stark import quotient as jquot
from zkvm_brainfuck_tpu.stark import uni as juni
from zkvm_brainfuck_tpu.stark.chip import Chip as JaxChip
from zkvm_brainfuck_tpu.stark.domains import Domain as JaxDomain
from zkvm_brainfuck_tpu_torch import build
from zkvm_brainfuck_tpu_torch.models.machine_def import brainfuck_chips
from zkvm_brainfuck_tpu_torch.ops import kernels as kn
from zkvm_brainfuck_tpu_torch.ops import quotient as oq
from zkvm_brainfuck_tpu_torch.ops.field import P
from zkvm_brainfuck_tpu_torch.stark import codegen
from zkvm_brainfuck_tpu_torch.stark import quotient as tquot
from zkvm_brainfuck_tpu_torch.stark.chip import Chip
from zkvm_brainfuck_tpu_torch.stark.domains import Domain, selectors_on_coset

LOG_N = 3  # trace rows 2^3; the quotient coset has 16 rows
CHIP_NAMES = [a.name for a in brainfuck_chips()]


def _chip(name):
    return Chip(next(a for a in brainfuck_chips() if a.name == name))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int32))


def _ef(rng):
    return tuple(int(x) for x in rng.integers(0, P, 4))


def _inputs(chip, seed, log_n=LOG_N, perm=True):
    """Seeded canonical LDE matrices (Nq rows) of the chip's main,
    preprocessed and permutation traces, and the challenges."""
    rng = np.random.default_rng(seed)
    nq = 2 << log_n
    mats = {"main": rng.integers(0, P, (nq, chip.width), dtype=np.uint32),
            "prep": (rng.integers(0, P, (nq, chip.preprocessed_width), dtype=np.uint32)
                     if chip.preprocessed_width else None),
            "perm": (rng.integers(0, P, (nq, 4 * chip.permutation_width), dtype=np.uint32)
                     if perm else None)}
    chal = dict(perm_challenges=(_ef(rng), _ef(rng)) if perm else None, alpha=_ef(rng),
                cumulative_sum=_ef(rng) if perm else None)
    return mats, chal


def _blocks(m, width, views=False):
    """Column blocks of `width` columns (the last narrower; a pair (f, w):
    a first block of f columns, then blocks of w), or one block for None:
    contiguous copies, or (`views`) views of one contiguous tensor."""
    if m is None:
        return None
    t = _t(m)
    if width is None:
        return [t]
    first, w = (0, width) if isinstance(width, int) else width
    n = t.shape[1]
    edges = [0] + list(range(first or w, n, w)) + [n]
    return [t[:, a:b] if views else t[:, a:b].contiguous() for a, b in zip(edges, edges[1:])]


def _domains(log_n):
    td = Domain(log_n, 1)
    return td, td.create_disjoint_domain(2 << log_n)


# ---------------------------------------------------------------------------
# The plain quotient against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_w", [None, 4], ids=["one block", "4-column blocks"])
@pytest.mark.parametrize("case", ["Cpu", "Program", "Cpu uni"])
def test_plain_quotient_equals_jax(case, block_w):
    name, perm = case.split()[0], case != "Cpu uni"
    chip = _chip(name)
    jchip = JaxChip(next(a for a in jax_chips() if a.name == name))
    mats, ch = _inputs(chip, seed=len(case), perm=perm)
    td, qd = _domains(LOG_N)
    jtd, jqd = JaxDomain(LOG_N, 1), JaxDomain(qd.log_n, qd.shift)
    got = tquot.quotient_values(chip, td, qd, _blocks(mats["prep"], block_w),
                                _blocks(mats["main"], block_w), _blocks(mats["perm"], block_w),
                                ch["perm_challenges"], ch["alpha"], ch["cumulative_sum"])

    def jblocks(m):
        if m is None:
            return None
        return [jf.to_monty(jnp.asarray(b.numpy().astype(np.uint32))) for b in _blocks(m, block_w)]

    if perm:
        want = jquot.quotient_values(
            jchip, jtd, jqd, jblocks(mats["prep"]), jblocks(mats["main"]), jblocks(mats["perm"]),
            ch["perm_challenges"], ch["alpha"],
            jf.to_monty(jnp.asarray(np.array(ch["cumulative_sum"], np.uint32))))
    else:
        want = juni._uni_quotient(jchip, jtd, jqd, jblocks(mats["main"])[0]
                                  if block_w is None else jnp.concatenate(jblocks(mats["main"]), 1),
                                  ch["alpha"])
    want = np.asarray(jf.from_monty(want)).astype(np.uint32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2 << LOG_N, 4)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


# ---------------------------------------------------------------------------
# The generated bodies on the host
# ---------------------------------------------------------------------------


def _host_lib(prog):
    """The program's source with csrc/quotient.cuh's host loop, compiled
    with g++ into the build directory (named by a hash; temporary name,
    then renamed)."""
    headers = [os.path.join(build.CSRC, h) for h in build.CUDA_HEADERS + (build.QUOTIENT_HEADER,)]
    h = hashlib.sha256(prog.text.encode())
    for p in headers:
        with open(p, "rb") as fh:
            h.update(fh.read())
    d = build.build_dir()
    lib = os.path.join(d, f"libzkbf_qhost_{prog.name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        fd, src = tempfile.mkstemp(suffix=".cpp", dir=d)
        with os.fdopen(fd, "w") as fh:
            fh.write(prog.text)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=d)
        os.close(fd)
        res = subprocess.run(["g++", "-O0", "-std=c++17", "-shared", "-fPIC", "-I", build.CSRC,
                              "-o", tmp, src], capture_output=True, text=True)
        os.unlink(src)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed on the {prog.name} quotient body:\n{res.stderr}")
        os.replace(tmp, lib)
    handle = ctypes.CDLL(lib)
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.zkbf_quotient_host.argtypes = [vp, vp, vp, vp, vp, i, vp, vp, i, i, i, vp]
    return handle


def _host_eval(chip, main, prep, perm, sels, step, ch, halo=None):
    """The generated body through the wrapper's block table, on the CPU:
    each tile staged into a host array of the kernel's pitch by the
    kernel's staging code, then its rows through the body."""
    prog = codegen.program(chip, perm is not None)
    local, hal, strides, hstrides, widths, n = oq.block_table(chip, main, prep, perm, halo)
    words = prog.params(ch["perm_challenges"], ch["alpha"], ch["cumulative_sum"])
    rows = int(main[0].shape[0])
    out = torch.zeros((rows, 4), dtype=torch.int32)
    sel = [sels[s].contiguous() for s in oq.SELECTORS]
    sel_ptrs = (ctypes.c_void_p * 4)(*[s.data_ptr() for s in sel])
    err = _host_lib(prog).zkbf_quotient_host(
        ctypes.addressof(local), ctypes.addressof(hal), ctypes.addressof(strides),
        ctypes.addressof(hstrides), ctypes.addressof(widths), n, ctypes.addressof(sel_ptrs),
        words.ctypes.data, len(words), rows, step, out.data_ptr())
    assert err == 0
    return out


@pytest.mark.parametrize("name", CHIP_NAMES)
def test_generated_body_equals_plain(name):
    """Whole LDE (one block, next rows wrap) and a shard of 4 (row0 = 8 of
    32 rows, 4-column blocks, its next rows past its last from a halo of
    the next shard's first rows), bit for bit against the plain version."""
    chip = _chip(name)
    log_n = LOG_N + 1
    mats, ch = _inputs(chip, seed=7 + CHIP_NAMES.index(name), log_n=log_n)
    td, qd = _domains(log_n)
    nq, step = qd.size, 1 << (qd.log_n - td.log_n)
    sels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cpu")
    whole = [_blocks(mats[k], None) for k in ("main", "prep", "perm")]
    plain = tquot.quotient_rows_plain(chip, whole[0], whole[1], whole[2], sels, step,
                                      ch["perm_challenges"], ch["alpha"], ch["cumulative_sum"])
    np.testing.assert_array_equal(_host_eval(chip, *whole, sels, step, ch).numpy(), plain.numpy())

    rows, row0 = nq // 4, nq // 4
    shard = [None if m is None else _blocks(m[row0:row0 + rows], 4)
             for m in (mats["main"], mats["prep"], mats["perm"])]
    halo = tuple(None if m is None else _blocks(m[row0 + rows:row0 + rows + step], 4)
                 for m in (mats["main"], mats["prep"], mats["perm"]))
    ssels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cpu", row0, rows)
    got = _host_eval(chip, *shard, ssels, step, ch, halo)
    np.testing.assert_array_equal(got.numpy(), plain[row0:row0 + rows].numpy())
    sp = tquot.quotient_rows_plain(chip, *shard, ssels, step, ch["perm_challenges"], ch["alpha"],
                                   ch["cumulative_sum"], halo)
    np.testing.assert_array_equal(sp.numpy(), plain[row0:row0 + rows].numpy())


TILE = 128  # csrc/quotient.cuh zkbfq::TILE: rows a block stages
# name: (trace log_n, blowup log, row0, rows or None for the whole LDE, block widths as
# _blocks takes them, views)
TILE_CASES = {
    # 2^9 coset rows, 4 tiles: the last tile's next rows wrap to rows 0 and 1
    "whole, the wrap at the last tile": (8, 1, 0, None, None, False),
    # 300 rows (2 tiles and 44), row views of each whole group: contiguous
    # runs that start 2 words past a 16-byte boundary; halo rows 338, 339
    "shard of 300 rows, row0 38": (8, 1, 38, 300, None, True),
    # fewer rows than a tile; 4-column blocks after a 2-column one, so
    # that EF4 planes straddle two blocks
    "shard of 100 rows, 4-column blocks, planes straddle": (8, 1, 400, 100, (2, 4), False),
    # a shard of 4 (row0 = Nq/4) at 2 tiles, 8-column blocks after a
    # 2-column one (planes straddle)
    "shard of 4, 8-column blocks, planes straddle": (8, 1, 128, 128, (2, 8), False),
    # column views of the whole matrix (row stride > width); 6 columns a
    # block, so EF4 planes straddle two blocks
    "6-column views, EF4 planes straddle": (8, 1, 0, None, 6, True),
    # next_step 4 (a 4x coset): the tile holds 4 rows past its last
    "next_step 4, 8-column blocks": (7, 2, 0, None, 8, False),
}


@pytest.mark.parametrize("name", CHIP_NAMES)
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tiled_body_equals_plain(case, name):
    """The generated body with the kernel's tile staging (16-byte runs,
    their unaligned heads and tails, views word by word, halo rows, a last
    tile of fewer rows) against the plain version, bit for bit."""
    log_n, log_blowup, row0, rows, width, views = TILE_CASES[case]
    chip = _chip(name)
    mats, ch = _inputs(chip, seed=70 + CHIP_NAMES.index(name), log_n=log_n + log_blowup - 1)
    td = Domain(log_n, 1)
    qd = td.create_disjoint_domain(1 << (log_n + log_blowup))
    nq, step = qd.size, 1 << log_blowup
    sels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cpu")
    whole = [_blocks(mats[k], None) for k in ("main", "prep", "perm")]
    plain = tquot.quotient_rows_plain(chip, *whole, sels, step, ch["perm_challenges"],
                                      ch["alpha"], ch["cumulative_sum"])
    groups = [_blocks(mats[k], width, views) for k in ("main", "prep", "perm")]
    if rows is None:
        got = _host_eval(chip, *groups, sels, step, ch)
        want = plain
    else:
        sub, nxt = slice(row0, row0 + rows), slice(row0 + rows, row0 + rows + step)
        shard = [None if g is None else [b[sub] for b in g] for g in groups]
        halo = tuple(None if g is None else [b[nxt] for b in g] for g in groups)
        ssels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cpu", row0, rows)
        got = _host_eval(chip, *shard, ssels, step, ch, halo)
        want = plain[sub]
    assert nq > TILE
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", CHIP_NAMES)
def test_params_equal_the_ef4_loop(name):
    """Program.params (the beta powers and fold weights by ef_host.powers)
    equals the words of an EF4 product loop exactly."""
    from zkvm_brainfuck_tpu_torch.stark import ef_host as efh

    chip = _chip(name)
    rng = np.random.default_rng(90 + CHIP_NAMES.index(name))
    alpha, beta, alpha2, cs = _ef(rng), _ef(rng), _ef(rng), _ef(rng)
    for perm in (True, False):
        prog = codegen.program(chip, perm)
        want = []
        if perm:
            want += list(alpha2) + list(beta)
            pw = [efh.ONE]
            for _ in range(prog.max_vals):
                pw.append(efh.mul(pw[-1], beta))
            want += [x for p in pw for x in p] + list(cs)
        pw = [efh.ONE]
        for _ in range(prog.k - 1):
            pw.append(efh.mul(pw[-1], alpha))
        want += [x for j in range(prog.k) for x in pw[prog.k - 1 - j]]
        got = prog.params((alpha2, beta) if perm else None, alpha, cs if perm else None)
        assert got.dtype == np.uint32 and got.tolist() == want


def test_generated_body_without_logup_equals_plain():
    """The uni-STARK's Cpu program (no permutation columns or parameters)."""
    chip = _chip("Cpu")
    mats, ch = _inputs(chip, seed=3, perm=False)
    td, qd = _domains(LOG_N)
    sels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cpu")
    main = _blocks(mats["main"], 4)
    plain = tquot.quotient_rows_plain(chip, main, None, None, sels, 2, None, ch["alpha"], None)
    np.testing.assert_array_equal(_host_eval(chip, main, None, None, sels, 2, ch).numpy(),
                                  plain.numpy())


# ---------------------------------------------------------------------------
# The recorder, the generated text, the wrapper on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CHIP_NAMES)
def test_recorded_flags_and_text_are_stable(name):
    a, b = _chip(name), _chip(name)
    pa, pb = codegen.program(a), codegen.program(b)
    assert pa.flags == tquot.constraint_ext_flags(a)
    assert pa is codegen.program(a)  # kept on the chip
    assert pa.text == pb.text
    assert (build._generated_jobs({pa.name: pa.text})
            == build._generated_jobs({pb.name: pb.text}))  # the library's name: its hash
    assert pa.n_cols == a.width + a.preprocessed_width + 4 * a.permutation_width
    assert f"#define ZKBF_Q_NCOL {pa.n_cols}" in pa.text
    assert pa.counts["products"] > 0 and pa.counts["loads"] > 0
    air = codegen.program(a, perm=False)
    assert air.text != pa.text and air.flags == pa.flags[:air.k]


def test_wrapper_runs_plain_on_cpu_and_checks_shapes():
    chip = _chip("AddSub")
    mats, ch = _inputs(chip, seed=5)
    td, qd = _domains(LOG_N)
    sels = selectors_on_coset(td.log_n, qd.log_n, qd.shift, "cpu")
    main, perm = _blocks(mats["main"], None), _blocks(mats["perm"], 4)
    kn.reset_counts()
    calls = tquot.PLAIN_CALLS
    got = oq.quotient_eval(chip, main, None, perm, sels, 2, **ch)
    assert tquot.PLAIN_CALLS == calls + 1 and kn.COUNTS["quotient_eval"] == 0
    want = tquot.quotient_values(chip, td, qd, None, main, perm, **ch)
    assert tquot.PLAIN_CALLS == calls + 2 and kn.COUNTS["quotient_eval"] == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="widths"):
        oq.quotient_eval(chip, [main[0][:, :3]], None, perm, sels, 2, **ch)
    with pytest.raises(ValueError, match="next-row step"):
        oq.quotient_eval(chip, [m[:1] for m in main], None, [p[:1] for p in perm],
                         {k: v[:1] for k, v in sels.items()}, 2, **ch)
    with pytest.raises(ValueError, match="halo"):
        oq.quotient_eval(chip, main, None, perm, sels, 2, **ch, halo=([main[0][:2]], None, None))
