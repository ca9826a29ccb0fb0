"""The sharded checkpoint of the port (TensorProblem.gathered_state,
load_checkpoint and state_layout; Transient.save_checkpoint and recover on
a mesh) on the CPU, against the port's own runs and the JAX package.

Ranks are spawned with torch.multiprocessing over gloo
(tests/torch_ranks.py), one spawn a world size: P = 4 first, then P = 2,
which reads P = 4's checkpoints.  The JAX package runs in this process on
the conftest's virtual CPU devices.  The decks stand in for the reference
deck that tests/test_checkpoint.py:29 opens (absent here):
decks.CH3D_DECK at 16³ on FFT_SLAB and FFT_PENCIL (DEFAULT float64, with
the postprocessors and CSV of tests/test_torch_parallel.py; on the slab
also PALLAS fused through the kernels' twins, whose carried ū is a
spectrum in the kernels' order, and the seeded RandomTensor start), and decks.POROUS_DECK
at 8³ under REAL_SPACE on JNP and PALLAS (the fused plan's twin).  Each
runs 4 steps uninterrupted, 2 steps with a checkpoint, and 2 more resumed.

- Within the port, at each mesh size, the resumed run equals the
  uninterrupted one bit for bit: every leaf of every rank, n_advances,
  old_dt, the postprocessor values and the CSV rows after the checkpoint.
- Across the packages (float64 decks): a JAX sharded checkpoint resumed
  by the port, and the port's resumed by the JAX package, equal the
  uninterrupted run within 1e-10.
- Across mesh sizes: a P = 4 checkpoint resumed at P = 2 and serially,
  and a serial one resumed at P = 2, within 1e-10 of the uninterrupted
  run (a pencil's pad rows are fitted to the mesh that reads them).
"""

import numpy as np
import pytest

from marlin_tpu_torch import decks, hit
from marlin_tpu_torch.executioner import run_deck

from tests import torch_ranks
from tests.test_torch_parallel import CSV_PPS, FUSED, ch3d, ch3d_random

TOL = 1e-10
STEPS, AT = 4, 2
WORLDS = (4, 2)  # P = 2 resumes P = 4's checkpoints
MEDIA = {"media": decks.porous_media(8)}


def _porous(backend):
    text = decks.POROUS_DECK.format(n=8, substeps=4, backend=backend, media_h5="media.h5")
    return text.replace("[Domain]", "[Domain]\n  parallel_mode = REAL_SPACE")


#: name -> (deck, mode, mesh shape by world size, arrays)
RUNS = {
    "slab": (ch3d("FFT_SLAB") + CSV_PPS, "FFT_SLAB", {4: None, 2: None}, None),
    "slab_fused": (ch3d("FFT_SLAB", "PALLAS", FUSED), "FFT_SLAB", {4: None, 2: None}, None),
    "slab_random": (ch3d_random("FFT_SLAB"), "FFT_SLAB", {4: None, 2: None}, None),
    "pencil": (ch3d("FFT_PENCIL") + CSV_PPS, "FFT_PENCIL", {4: (2, 2), 2: (1, 2)}, None),
    "porous_jnp": (_porous("JNP"), "REAL_SPACE", {4: (2, 2), 2: (2,)}, MEDIA),
    "porous_pallas": (_porous("PALLAS"), "REAL_SPACE", {4: (4,), 2: (2,)}, MEDIA),
}
#: the float64 runs held across packages and mesh sizes: name -> the JAX
#: package's world size (its mesh as the port's at that size)
CROSS = {"slab": 2, "pencil": 4, "porous_jnp": 4}


def _ckpt(tmp, name, how, world):
    return str(tmp / f"{name}_{how}_{world}" / "rank0" / "ck_checkpoint.npz")


def _case(tmp, name, how, world, steps=STEPS, checkpoint_at=0, recover=None):
    text, mode, meshes, arrays = RUNS[name]
    return ("resume_run", dict(text=text, mode=mode, mesh_shape=meshes[world],
                               arrays=arrays, steps=steps, checkpoint_at=checkpoint_at,
                               recover=recover,
                               output_dir=str(tmp / f"{name}_{how}_{world}")))


def _cases(world, tmp):
    cases = []
    for name in RUNS:
        cases += [_case(tmp, name, "full", world),
                  _case(tmp, name, "part", world, steps=AT, checkpoint_at=AT),
                  _case(tmp, name, "res", world, recover=_ckpt(tmp, name, "part", world))]
    for name, jworld in CROSS.items():
        if jworld == world:
            cases.append(_case(tmp, name, "fromjax", world,
                               recover=str(tmp / f"jax_{name}" / "ck_checkpoint.npz")))
        if world == 2:
            cases.append(_case(tmp, name, "from4", world,
                               recover=_ckpt(tmp, name, "part", 4)))
            cases.append(_case(tmp, name, "fromserial", world,
                               recover=str(tmp / f"serial_{name}_part" / "ck_checkpoint.npz")))
    return cases


# -- the JAX package ----------------------------------------------------------------


def _jax_text(name, tmp):
    """The deck for the JAX package: the media as an h5 file it reads."""
    text, _mode, _meshes, arrays = RUNS[name]
    if arrays is not None:
        import h5py

        path = tmp / "media.h5"
        with h5py.File(path, "w") as f:
            f.create_dataset("media", data=arrays["media"])
        text = text.replace("file = media.h5", f"file = {path}")
    return text


def _jax_transient(name, tmp, out, steps):
    import jax

    from marlin_tpu import hit as jhit
    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import ParallelMode
    from marlin_tpu.executioner import Transient as JTransient
    from marlin_tpu.problem import TensorProblem as JProblem

    _text, mode, meshes, _arrays = RUNS[name]
    world = CROSS[name]
    shape = meshes[world]
    kw = {} if shape is None else {"shape": shape}
    mesh = jpar.make_mesh(getattr(ParallelMode, mode), jax.devices()[:world], **kw)
    root = jhit.parse(_jax_text(name, tmp))
    hit_ex = root.child("Executioner", create=True)
    hit_ex.set_param("num_steps", str(steps))
    return JTransient(JProblem(root, mesh=mesh), exec_node=root.children.get("Executioner"),
                      outputs_node=root.children.get("Outputs"), file_base="ck",
                      output_dir=str(out))


# -- serial runs of the port --------------------------------------------------------


def _serial(name, out, steps, checkpoint_at=0, recover=None):
    text, _mode, _meshes, arrays = RUNS[name]
    root = hit.parse(text)
    ex = root.child("Executioner", create=True)
    ex.set_param("num_steps", str(steps))
    if checkpoint_at:
        ex.set_param("checkpoint_interval", str(checkpoint_at))
    return run_deck(root, device="cpu", arrays=arrays, output_dir=str(out), file_base="ck",
                    recover=recover)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's checkpoints and the serial ones first, then every
    case on P = 4 and P = 2."""
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    for name in CROSS:
        jt = _jax_transient(name, tmp, tmp / f"jax_{name}", AT)
        jt.run()
        jt.save_checkpoint()
        _serial(name, tmp / f"serial_{name}_part", AT, checkpoint_at=AT)
    out = {"tmp": tmp}
    for world in WORLDS:
        cases = _cases(world, tmp)
        res = torch_ranks.spawn(world, cases, tmp, deadline=240.0)
        out[world] = {kw["output_dir"].rsplit("/", 1)[1]: r for (_k, kw), r in zip(cases, res)}
    return out


def _ranks(runs, name, how, world):
    return runs[world][f"{name}_{how}_{world}"]


def _assert_equal_leaves(got, want, tol=None):
    """Two runs' leaves on the same mesh, rank by rank: bit for bit, or
    within ``tol``."""
    for g, w in zip(got, want):
        for part in ("buffers", "old", "solver"):
            assert set(g[part]) == set(w[part]), part
            for k, (arr, layout) in w[part].items():
                garr, glayout = g[part][k]
                assert glayout == layout and garr.shape == arr.shape, (part, k)
                assert garr.dtype == arr.dtype, (part, k)
                if tol is None:
                    assert np.array_equal(garr, arr), (part, k)
                else:
                    np.testing.assert_allclose(garr, arr, rtol=0, atol=tol,
                                               err_msg=f"{part}/{k}")
        assert g["n_advances"] == w["n_advances"]
        assert g["step"] == w["step"] == STEPS


def _assembled(res, part, key, shape):
    """A leaf's global array from every rank's block, by its layout's
    slices (an axis of extent 1 where the block's slice is longer is a
    broadcast, whole)."""
    arr, layout = res[0][part][key]
    if layout is None:
        return arr
    lead = 1 if part == "old" else 0
    blocks = []
    for r in res:
        block, _ = r[part][key]
        sl = r["slices"][layout]
        idx = [slice(None)] * lead
        for d, s in enumerate(sl):
            ext = block.shape[lead + d]
            idx.append(s if ext == s.stop - s.start else slice(0, ext))
        blocks.append((tuple(idx), block))
    return torch_ranks.assemble(blocks, shape[:lead + len(res[0]["slices"][layout])])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(RUNS))
def test_resume_is_bit_exact_on_a_mesh(runs, name, world):
    full = _ranks(runs, name, "full", world)
    res = _ranks(runs, name, "res", world)
    _assert_equal_leaves(res, full)
    for r, f in zip(res, full):
        assert r["old_dt"] == f["old_dt"] and r["time"] == f["time"]
        assert r["pps"] == f["pps"]
    if full[0]["csv"] is not None:
        # rank 0 writes the CSV: the rows after the checkpoint's step
        assert res[0]["csv"][1:] == full[0]["csv"][AT + 2:]
        assert all(r["csv"] is None for r in res[1:])


def test_checkpoint_holds_global_arrays(runs):
    """The file of a mesh run is the serial layout: every buffer at its
    global shape, as the serial run's file holds it."""
    tmp = runs["tmp"]
    with np.load(_ckpt(tmp, "slab", "part", 4)) as a, \
            np.load(str(tmp / "serial_slab_part" / "ck_checkpoint.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k == "__meta__":
                continue  # the postprocessor values of another run
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k.startswith("buffers/"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CROSS))
def test_jax_sharded_checkpoint_resumes_in_the_port(runs, name):
    world = CROSS[name]
    _assert_equal_leaves(_ranks(runs, name, "fromjax", world),
                         _ranks(runs, name, "full", world), tol=TOL)


@pytest.mark.parametrize("name", list(CROSS))
def test_port_sharded_checkpoint_resumes_in_jax(runs, name):
    world = CROSS[name]
    tmp = runs["tmp"]
    jt = _jax_transient(name, tmp, tmp / f"jax_res_{name}", STEPS)
    jt.init()
    jt.recover(_ckpt(tmp, name, "part", world))
    jt.run()
    full = _ranks(runs, name, "full", world)
    assert jt.step_count == STEPS
    for k, v in jt.state["buffers"].items():
        v = np.asarray(v)
        np.testing.assert_allclose(_assembled(full, "buffers", k, v.shape), v, rtol=0,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("how", ["from4", "fromserial"])
@pytest.mark.parametrize("name", list(CROSS))
def test_checkpoint_resumes_at_another_mesh_size(runs, name, how):
    _assert_equal_leaves(_ranks(runs, name, how, 2), _ranks(runs, name, "full", 2),
                         tol=TOL)


@pytest.mark.parametrize("name", list(CROSS))
def test_mesh_checkpoint_resumes_serially(runs, name, tmp_path):
    full = _serial(name, tmp_path / "full", STEPS)
    res = _serial(name, tmp_path / "res", STEPS, recover=_ckpt(runs["tmp"], name, "part", 4))
    assert res.step_count == full.step_count == STEPS
    for part in ("buffers", "old"):
        for k, v in full.state[part].items():
            np.testing.assert_allclose(res.state[part][k].numpy(), v.numpy(), rtol=0,
                                       atol=TOL, err_msg=f"{part}/{k}")

