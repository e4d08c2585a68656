"""The port's GPipe schedule (``repro_torch.sharding.pipeline``) on a (4,)
``pipe`` mesh of 4 gloo CPU processes against the JAX package's ``gpipe``
on ``jax.make_mesh((4,), ('pipe',))`` (4 forced host devices, one oracle
subprocess) and against both packages' ``sequential_reference``, from the
same numpy stage parameters and microbatches (the JAX test's stage, tanh(x
@ w + b), in f32): outputs within 1e-5 on every rank; the gradients of x
and of the stage parameters, through the schedule's collectives, within
1e-5 of the port's ``sequential_reference`` gradient; M + P - 2 handoffs
each way and one psum each way. M = 8 microbatches, and M = 2 < P.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import assert_close

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
P_STAGES, MB, D = 4, 2, 16
MICRO = {"m8": 8, "m2": 2}

ORACLE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro.sharding.pipeline import gpipe, sequential_reference

work = sys.argv[1]
cases = pickle.load(open(os.path.join(work, "cases.pkl"), "rb"))
mesh = jax.make_mesh((4,), ("pipe",), axis_types=(jax.sharding.AxisType.Auto,))
stage = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
out = {}
for name, (params, x) in cases.items():
    sp = {k: jnp.asarray(v) for k, v in params.items() if k != "cot"}
    out[name] = dict(gpipe=jax.numpy.asarray(jax.jit(lambda s, x: gpipe(stage, s, x, mesh=mesh))(sp, jnp.asarray(x))),
                     seq=sequential_reference(stage, sp, jnp.asarray(x)))
pickle.dump({k: {f: __import__("numpy").asarray(v) for f, v in d.items()} for k, d in out.items()},
            open(os.path.join(work, "jax_out.pkl"), "wb"))
"""


def _cases():
    rng = np.random.default_rng(4)
    out = {}
    for name, m in MICRO.items():
        params = {"w": (0.3 * rng.standard_normal((P_STAGES, D, D))).astype(np.float32),
                  "b": (0.1 * rng.standard_normal((P_STAGES, D))).astype(np.float32),
                  "cot": rng.standard_normal((m, MB, D)).astype(np.float32)}
        out[name] = (params, rng.standard_normal((m, MB, D)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("gpipe")
    cases = _cases()
    (work / "cases.pkl").write_bytes(pickle.dumps(cases))
    (work / "oracle.py").write_text(ORACLE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, str(work / "oracle.py"), str(work)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = ranks.run_ranks(ranks.gpipe_run, work, cases, shape=(P_STAGES,), axes=("pipe",))
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return dict(cases=cases, port=port, jax=pickle.loads((work / "jax_out.pkl").read_bytes()))


def _sequential(params, x):
    """The port's ``sequential_reference`` and its gradients of sum(out * cot)."""
    from repro_torch.sharding.pipeline import sequential_reference

    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items() if k != "cot"}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = sequential_reference(ranks.pipe_stage, p, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(params["cot"])).sum(), [xt] + list(p.values()))
    return out.detach().numpy(), grads[0].numpy(), {k: g.numpy() for k, g in zip(p, grads[1:])}


@pytest.mark.parametrize("name", list(MICRO))
def test_gpipe_matches_jax_and_the_sequential_reference(runs, name):
    params, x = runs["cases"][name]
    seq, _, _ = _sequential(params, x)
    assert_close(seq, runs["jax"][name]["seq"], TOL, "port sequential against JAX's")
    for r in runs["port"]:
        assert_close(r[name]["out"], runs["jax"][name]["gpipe"], TOL, "gpipe against JAX's gpipe")
        assert_close(r[name]["out"], seq, TOL, "gpipe against sequential")


@pytest.mark.parametrize("name", list(MICRO))
def test_gpipe_gradients_match_the_sequential_reference(runs, name):
    params, x = runs["cases"][name]
    _, gx, gp = _sequential(params, x)
    for r in runs["port"]:
        assert_close(r[name]["gx"], gx, TOL, "dx")
        for k in gp:
            assert_close(r[name]["gp"][k], gp[k], TOL, f"d{k}")


@pytest.mark.parametrize("name", list(MICRO))
def test_gpipe_schedule_collectives(runs, name):
    handoffs = MICRO[name] + P_STAGES - 2    # one a tick but the last
    for r in runs["port"]:
        assert r[name]["calls"] == {"ppermute": 2 * handoffs, "psum": 2}
