"""The port's multi-host launch (marlin_tpu_torch/main.py): the JAX
package's MARLIN_TPU_COORDINATOR, MARLIN_TPU_NUM_PROCESSES and
MARLIN_TPU_PROCESS_ID variables form the default group (gloo on the CPU,
``tcp://<coordinator>``), as tests/test_multihost.py drives the JAX
package's ``jax.distributed.initialize``.  The CLI runs in subprocesses
(a process group is global, irreversible state), with one process, and
with two processes on one coordinator, on the JAX test's FFT_SLAB deck:
each finishes after 2 steps, and the ``avg`` it prints equals the JAX
package's within 1e-12.  A coordinator that cannot be reached fails the
run; it never falls back to a serial one."""

import os
import socket
import subprocess
import sys

import pytest

from tests.test_multihost import SCRIPT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = SCRIPT.split("deck = '''")[1].split("'''")[0]
TIMEOUT = 120


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(tmp_path, coordinator, world, rank):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(MARLIN_TPU_COORDINATOR=coordinator, MARLIN_TPU_NUM_PROCESSES=str(world),
               MARLIN_TPU_PROCESS_ID=str(rank), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def _launch(tmp_path, world, coordinator=None):
    deck = tmp_path / "multihost.i"
    deck.write_text(DECK)
    coordinator = coordinator or f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "marlin_tpu_torch", str(deck), "--compute-device", "cpu",
         "--output-dir", str(tmp_path / f"rank{r}")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(tmp_path),
        env=_env(tmp_path, coordinator, world, r)) for r in range(world)]
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def jax_avg(tmp_path_factory):
    """The JAX package's ``avg`` of the deck after its 2 steps, on a
    two-device slab."""
    import jax

    from marlin_tpu import hit as jhit
    from marlin_tpu import parallel as jpar
    from marlin_tpu.domain import ParallelMode
    from marlin_tpu.executioner import Transient
    from marlin_tpu.problem import TensorProblem

    root = jhit.parse(DECK)
    jhit.expand_braces(root)
    mesh = jpar.make_mesh(ParallelMode.FFT_SLAB, jax.devices()[:2])
    tr = Transient(TensorProblem(root, mesh=mesh), exec_node=root.children.get("Executioner"),
                   outputs_node=root.children.get("Outputs"), file_base="mh",
                   output_dir=str(tmp_path_factory.mktemp("jax_multihost")))
    return tr.run()["avg"]


def _avg(stdout):
    line = [ln for ln in stdout.splitlines() if ln.strip().startswith("avg = ")]
    assert len(line) == 1, stdout
    return float(line[0].split("=")[1])


@pytest.mark.parametrize("world", [1, 2])
def test_marlin_tpu_variables_form_the_group(tmp_path, jax_avg, world):
    results = _launch(tmp_path, world)
    for rc, _stdout, stderr in results:
        assert rc == 0, stderr[-2000:]
    # rank 0 alone prints
    stdout = results[0][1]
    assert "Finished after 2 steps" in stdout
    assert all("Finished" not in out for _rc, out, _err in results[1:])
    assert _avg(stdout) == pytest.approx(jax_avg, rel=0, abs=1e-12)


def test_a_group_that_cannot_form_fails_the_run(tmp_path):
    (rc, stdout, _stderr), = _launch(tmp_path, 1, coordinator="localhost:not-a-port")
    assert rc != 0 and "Finished" not in stdout
