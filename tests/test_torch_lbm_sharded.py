"""Lattice Boltzmann under REAL_SPACE on the CPU: the port's sharded eager
chain (JNP) and fused plan (PALLAS, kernel 7's halo branch through its
twin) against the port's serial run and the JAX package's sharded run, the
halo twin against the unsharded twin in one process, and the named errors.

Ranks are spawned with torch.multiprocessing over gloo (tests/torch_ranks.py),
one spawn a world size: P = 2 on a 1-D mesh, P = 4 on a 1-D and a 2 × 2
mesh.  The in-repo decks stand in for the reference decks that
tests/test_pallas_lbm.py:479-620, :820 and :951 open (absent here): the
porous deck with media, bounce-back on all faces (x faces on the grid's
coordinates), the Zou-He inlet/outlet channel, the two-lattice thermal
chain, a D2Q9 channel (1-D meshes only) and, on JNP, the Kármán deck
(Smagorinsky: its mean density over the whole grid).

Tolerance: tests/test_pallas_lbm.py:42's 1e-12 on every buffer, every old
slot, the residual and n_advances; the halo twin bit for bit.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch import lbm_fused as lf
from marlin_tpu_torch.problem import TensorProblem

from tests import torch_ranks

TOL = 1e-12
STEPS = 3
MESHES = {2: [(2,)], 4: [(4,), (2, 2)]}
BACKENDS = ("JNP", "PALLAS")


def _deck(name, backend):
    """(deck text, arrays) of a case at its test size."""
    if name == "porous":
        return (decks.POROUS_DECK.format(n=8, substeps=4, backend=backend,
                                         media_h5="media.h5"),
                {"media": decks.porous_media(8)})
    if name == "allface":
        return decks.ALLFACE_DECK.format(n=8, stencil="LBMD3Q19", backend=backend), None
    if name == "corners":
        # every face with exclude_corners_{x,y,z}: along a cut axis a block
        # drops the grid's first and last planes only where it holds them
        text = decks.ALLFACE_DECK.format(n=8, stencil="LBMD3Q19", backend=backend)
        return text.replace("type = LBMBounceBack\n", "type = LBMBounceBack\n"
                            + "".join(f"      exclude_corners_{a} = true\n" for a in "xyz")), None
    if name == "inlet_outlet":
        return decks.INLET_OUTLET_DECK.format(backend=backend), None
    if name == "thermal":
        return decks.THERMAL3D_DECK.format(n=8, substeps=4, backend=backend), None
    if name == "channel2d":
        return decks.CHANNEL2D_DECK.format(nx=16, ny=8, substeps=4, backend=backend), None
    if name == "karman":
        return (decks.KARMAN_DECK.format(nx=40, ny=20, substeps=3, backend=backend),
                {"binary_media": decks.karman_media(40, 20)})
    raise KeyError(name)


#: the runs: (deck, backend, mesh)
RUNS = [(d, b, m) for d in ("porous", "allface", "inlet_outlet", "thermal")
        for b in BACKENDS for w in MESHES for m in MESHES[w]]
RUNS += [("channel2d", b, (w,)) for b in BACKENDS for w in MESHES]
RUNS += [("karman", "JNP", (w,)) for w in MESHES]
#: LBMBounceBack's corner exclusion along cut axes (the fused plan refuses
#: exclude_corners_*, as the JAX package's does: JNP only)
CORNERS = [("corners", "JNP", m) for w in MESHES for m in MESHES[w]]
RUNS += CORNERS


def _sharded(text):
    return text.replace("[Domain]", "[Domain]\n  parallel_mode = REAL_SPACE")


#: named errors on a mesh: case -> (deck, backend, mesh, the words)
ERRORS = {
    # pallas_lbm.py:1373
    "smagorinsky": ("karman", "PALLAS", (2,), "Smagorinsky collisions do not fuse on "
                    "sharded domains (the mean density is a cross-shard reduction)"),
    # pallas_lbm.py:1128
    "2d_on_2d_mesh": ("channel2d", "PALLAS", (2, 2),
                      "2-D decks support 1-D (x-sharded) meshes only"),
}


def _cases(world, tmp):
    cases = []
    for name, backend, mesh in RUNS:
        if math.prod(mesh) != world:
            continue
        text, arrays = _deck(name, backend)
        cases.append(("deck_run", dict(text=_sharded(text), steps=STEPS, mode="REAL_SPACE",
                                       mesh_shape=mesh, arrays=arrays, buffers=None,
                                       old=None)))
    for name, backend, mesh, _words in ERRORS.values():
        if math.prod(mesh) == world:
            text, arrays = _deck(name, backend)
            cases.append(("named_error", dict(text=_sharded(text), mode="REAL_SPACE",
                                              mesh_shape=mesh, arrays=arrays,
                                              output_dir=str(tmp / "err"))))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lbm_ranks")
    out = {}
    for world in MESHES:
        cases = _cases(world, tmp)
        out[world] = list(zip(cases, torch_ranks.spawn(world, cases, tmp)))
    return out


def _ranks_of(ranks, name, backend, mesh):
    text, _arrays = _deck(name, backend)
    for (kind, kw), res in ranks[math.prod(mesh)]:
        if kind == "deck_run" and kw["text"] == _sharded(text) and kw["mesh_shape"] == mesh:
            return res
    raise KeyError((name, backend, mesh))


def _serial(name, backend):
    text, arrays = _deck(name, backend)
    p = TensorProblem(hit.parse(text), device="cpu", arrays=arrays)
    s = p.init_state()
    for i in range(STEPS):
        s = p.step(s, float(i), 1.0, 1.0, i == 0)
    return s


@pytest.fixture(scope="module")
def jx():
    """The JAX package, its fused LBM kernel in interpret mode."""
    import jax
    import jax.numpy as jnp

    import marlin_tpu.pallas_lbm as PL
    from marlin_tpu import hit as jhit
    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import ParallelMode
    from marlin_tpu.problem import TensorProblem as JProblem

    old = PL._INTERPRET
    PL._INTERPRET = True
    yield type("JX", (), dict(jax=jax, jnp=jnp, hit=jhit, par=jpar, Mode=ParallelMode,
                              Problem=JProblem, PL=PL))
    PL._INTERPRET = old


def _jax_sharded(jx, name, backend, mesh, tmp_path):
    """The JAX package's run on a mesh of the conftest's virtual devices
    (tests/test_pallas_lbm.py's sharded tests); media through an h5 file."""
    text, arrays = _deck(name, backend)
    if arrays is not None:
        import h5py

        (key, data), = arrays.items()
        path = tmp_path / f"{key}.h5"
        with h5py.File(path, "w") as f:
            f.create_dataset(key, data=data)
        text = text.replace(f"file = {key}.h5", f"file = {path}")
    jmesh = jx.par.make_mesh(jx.Mode.REAL_SPACE, jx.jax.devices()[:math.prod(mesh)],
                             shape=mesh)
    p = jx.Problem(jx.hit.parse(_sharded(text)), mesh=jmesh)
    s = p.init_state()
    dt = jx.jnp.asarray(1.0, p.domain.dtype)
    for i in range(STEPS):
        s = p.step(s, float(i), dt, dt, i == 0)
    return s


def _assert_parity(res, ref, tol=TOL, exact=False):
    """Every buffer and old slot of the blocks put together against
    ``ref`` (a state of numpy-able arrays), the residual and n_advances
    (tests/test_pallas_lbm.py:_assert_state_parity); with ``exact`` every
    buffer and slot bit for bit."""
    for group in ("buffers", "old"):
        for key, want in ref[group].items():
            want = np.asarray(want)
            lead = 1 if group == "old" else 0
            blocks = []
            for r in res:
                sl = r["slice"]
                if len(sl) < 3 and want.ndim > lead + 2:
                    sl = tuple(sl) + (slice(None),)
                blocks.append(((slice(None),) * lead + tuple(sl), r[group][key]))
            got = np.zeros_like(want)
            for sl, b in blocks:
                got[sl] = b
            d = np.max(np.abs(got - want)) if want.size else 0.0
            assert d < tol, f"{group}[{key}]: maxdiff {d}"
            assert not exact or np.array_equal(got, want), f"{group}[{key}] not bit for bit"
    for r in res:
        assert abs(r["residual"] - float(ref["solver"]["residual"])) < tol
        assert int(r["n_advances"]) == int(ref["n_advances"])


@pytest.mark.parametrize("name,backend,mesh", RUNS,
                         ids=[f"{d}-{b}-{'x'.join(map(str, m))}" for d, b, m in RUNS])
def test_real_space_matches_serial(ranks, name, backend, mesh):
    res = _ranks_of(ranks, name, backend, mesh)
    serial = _serial(name, backend)
    ref = {"buffers": {k: v.numpy() for k, v in serial["buffers"].items()},
           "old": {k: v.numpy() for k, v in serial["old"].items()},
           "solver": serial["solver"], "n_advances": serial["n_advances"]}
    _assert_parity(res, ref)


#: the JAX package's sharded runs held: (deck, backend, mesh)
JAX_RUNS = [("porous", "JNP", (2, 2)), ("allface", "PALLAS", (4,)),
            ("inlet_outlet", "JNP", (2, 2)), ("thermal", "PALLAS", (2,)),
            ("channel2d", "JNP", (4,))]


@pytest.mark.parametrize("name,backend,mesh", JAX_RUNS,
                         ids=[f"{d}-{b}-{'x'.join(map(str, m))}" for d, b, m in JAX_RUNS])
def test_real_space_matches_jax_sharded(ranks, jx, tmp_path, name, backend, mesh):
    """The port's block runs against the JAX package's sharded run of the
    same deck on the same mesh (GSPMD's halos, its fused kernel's sharded
    branch in interpret mode)."""
    res = _ranks_of(ranks, name, backend, mesh)
    _assert_parity(res, _jax_sharded(jx, name, backend, mesh, tmp_path))


@pytest.mark.parametrize("mesh", [m for _n, _b, m in CORNERS],
                         ids=["x".join(map(str, m)) for _n, _b, m in CORNERS])
def test_corner_exclusion_on_a_cut_axis(ranks, jx, tmp_path, mesh):
    """exclude_corners_{x,y,z} on every face, with x (and y) cut: the
    blocks put together equal the serial run bit for bit (the residual, a
    reduction, within 1e-12), and the JAX package's run of the deck, which
    slices its global array, within 1e-12.  That is the JAX package's
    serial run: its sharded run of this deck parts from its own serial
    run by about 1e-3 wherever exclude_corners_x meets a cut x axis
    (ROADMAP §3), so it is not the reference here."""
    res = _ranks_of(ranks, "corners", "JNP", mesh)
    serial = _serial("corners", "JNP")
    ref = {"buffers": {k: v.numpy() for k, v in serial["buffers"].items()},
           "old": {k: v.numpy() for k, v in serial["old"].items()},
           "solver": serial["solver"], "n_advances": serial["n_advances"]}
    _assert_parity(res, ref, exact=True)
    text, _arrays = _deck("corners", "JNP")
    p = jx.Problem(jx.hit.parse(text))
    s = p.init_state()
    dt = jx.jnp.asarray(1.0, p.domain.dtype)
    for i in range(STEPS):
        s = p.step(s, float(i), dt, dt, i == 0)
    _assert_parity(res, s)


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_named_errors_in_the_jax_words(ranks, jx, tmp_path, case):
    name, backend, mesh, words = ERRORS[case]
    text, _arrays = _deck(name, backend)
    found = [res for (kind, kw), res in ranks[math.prod(mesh)]
             if kind == "named_error" and kw["text"] == _sharded(text)
             and kw["mesh_shape"] == mesh]
    assert found and all(r is not None and words in r for r in found[0]), found
    with pytest.raises(jx.PL.FusedChainError, match=words.replace("(", r"\(")
                       .replace(")", r"\)")):
        _jax_sharded(jx, name, backend, mesh, tmp_path)


def test_real_space_without_a_mesh_is_refused_by_the_fused_plan():
    text, _ = _deck("allface", "PALLAS")
    p = TensorProblem(hit.parse(_sharded(text)), device="cpu")
    s = p.init_state()
    s = p.step(s, 0.0, 1.0, 1.0, True)
    with pytest.raises(lf.FusedChainError,
                       match=r"REAL_SPACE requires a 1-D \(x\) or 2-D \(x×y\) mesh"):
        p.step(s, 1.0, 1.0, 1.0, False)


# -- the halo twin in one process -------------------------------------------------------


def _plan(name):
    text, arrays = _deck(name, "PALLAS")
    p = TensorProblem(hit.parse(text), device="cpu", arrays=arrays)
    p.init_state()
    return lf.match_chain(p).config


HALO = {"porous": ((8, 8, 6), [(2, 1), (4, 1), (2, 2)]),
        "allface": ((8, 8, 6), [(2, 1), (4, 1), (2, 2)]),
        "inlet_outlet": ((8, 8, 6), [(2, 1), (2, 2)]),
        "thermal": ((8, 8, 6), [(2, 1), (4, 1), (2, 2)]),
        "channel2d": ((16, 8, 1), [(2, 1), (4, 1)])}


@pytest.mark.parametrize("name", sorted(HALO))
def test_halo_twin_equals_unsharded_twin(name):
    """Blocks cut from one field, their halos sliced from the neighbours
    (lbm_fused.block_halo), each run through the twin with its rings: put
    together they equal the unsharded twin bit for bit."""
    shape, splits = HALO[name]
    cfg = dataclasses.replace(_plan(name), nx=shape[0], ny=shape[1], nz=shape[2])
    gen = torch.Generator().manual_seed(7)
    f = torch.rand((cfg.q,) + shape, generator=gen, dtype=torch.float64)
    g = torch.rand((cfg.q,) + shape, generator=gen, dtype=torch.float64) \
        if cfg.two_lattice else None
    m = (torch.rand(shape, generator=gen) > 0.2).to(torch.int8) if cfg.has_media else None
    ref = lf.fused_substep_twin(f, m, cfg, g)
    for split in splits:
        outs = {}
        for ij in itertools.product(range(split[0]), range(split[1])):
            b, offs = lf.shard_plan(cfg, split, ij)
            fb, fr = lf.block_halo(f, b, offs, 1)
            gb, gr = lf.block_halo(g, b, offs, 1) if g is not None else (None, None)
            mb, mr = lf.block_halo(m, b, offs, 0) if m is not None else (None, None)
            outs[ij] = lf.fused_substep(fb, mb, b, gb, rings=(fr, gr, mr), offsets=offs)
        for k in range(len(ref)):
            got = torch.cat([torch.cat([outs[(i, j)][k] for j in range(split[1])], dim=-2)
                             for i in range(split[0])], dim=-3)
            assert torch.equal(got, ref[k]), (name, split, k)


@pytest.mark.parametrize("by", [1, 3])
@pytest.mark.parametrize("name", sorted(n for n in HALO if HALO[n][0][2] > 1))
def test_brick_rows_read_the_padded_block(name, by):
    """The halo brick's producer, mirrored (``lf.brick_rows`` and
    ``lf.media_rows``, csrc/lbm_substep.cuh ``halo_row``): for every brick
    of every block at each split and every direction, the rows it names in
    (block, ring) are the rows of ``parallel.ring_to_padded`` that the
    brick pulls from, plane x - e_x and row y - e_y; likewise the media
    rows of planes x - 1 .. x + 1 and rows y0 - 1 .. y0 + rows.  Bricks of
    1 and 3 rows (a short last brick at y = ny)."""
    from marlin_tpu_torch.parallel import ring_to_padded

    shape, splits = HALO[name]
    cfg = dataclasses.replace(_plan(name), nx=shape[0], ny=shape[1], nz=shape[2])
    f = torch.arange(cfg.q * math.prod(shape), dtype=torch.float64).reshape((cfg.q,) + shape)
    m = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    for split in [(1, 1), (2, 1), (4, 1), (2, 2)]:
        for ij in itertools.product(range(split[0]), range(split[1])):
            b, offs = lf.shard_plan(cfg, split, ij)
            fb, fr = lf.block_halo(f, b, offs, 1)
            mb, mr = lf.block_halo(m, b, offs, 0)
            fpad = ring_to_padded(fb, fr, 1, b.shard_y)
            mpad = ring_to_padded(mb, mr, 0, b.shard_y)
            dy = 1 if b.shard_y else 0

            def row(buf, ring, source):
                kind, off = source
                assert off % b.nz == 0
                return (buf.reshape(-1) if kind == "block" else ring)[off:off + b.nz]

            for x, y0 in itertools.product(range(b.nx), range(0, b.ny, by)):
                brick = (x, y0, min(by, b.ny - y0))
                for q, (ex, ey, _ez) in enumerate(b.e):
                    for j, src in enumerate(lf.brick_rows(b, brick, q)):
                        sy = y0 + j - ey + dy if b.shard_y else (y0 + j - ey) % b.ny
                        assert torch.equal(row(fb[q], fr[q], src), fpad[q, x - ex + 1, sy])
                for dx, rows in enumerate(lf.media_rows(b, brick)):
                    for jj, src in enumerate(rows):
                        sy = y0 + jj - 1 + dy if b.shard_y else (y0 + jj - 1) % b.ny
                        assert torch.equal(row(mb, mr, src), mpad[x + dx, sy])


def test_rings_are_checked_against_the_plan():
    cfg = dataclasses.replace(_plan("porous"), nx=8, ny=8, nz=6)
    b, offs = lf.shard_plan(cfg, (2, 1), (0, 0))
    f = torch.rand((cfg.q, 8, 8, 6), dtype=torch.float64)
    m = torch.ones((8, 8, 6), dtype=torch.int8)
    fb, fr = lf.block_halo(f, b, offs, 1)
    mb, mr = lf.block_halo(m, b, offs, 0)
    with pytest.raises(ValueError, match="mring must be given"):
        lf.fused_substep(fb, mb, b, rings=(fr, None, None))
    with pytest.raises(ValueError, match="halo rings given to an unsharded plan"):
        lf.fused_substep(f, m, cfg, rings=(fr, None, mr))
