"""The port's twins of the example scripts against the JAX package on the
CPU:

* ``repro_torch.examples.quickstart`` prints the same parameter count and
  second-moment savings as ``examples/quickstart.py`` (run as a script),
  and, from the JAX script's weights, its first 3 losses match the JAX
  package's ``make_train_step`` with the same optimizer and batches (1e-5
  relative);
* ``repro_torch.examples.diy_slim`` on reduced jamba with a shortened probe
  (12 Adam steps, SNR every 4) and the JAX package's Trainer doing the
  script's steps from the same weights: the averaged SNR tables have the
  same keys and agree to 1e-4 of the table's largest SNR (the first Mamba
  layer's ``x_proj`` has SNRs of 1e-9 and 0 after 12 steps, noise that
  agrees only absolutely), the derived rules are equal wherever the SNR is
  not within 1 % of the cutoff, and the savings are equal; the SlimAdam
  runs end at the same loss (1e-3 relative);
* both twins' command lines run to the end on the CPU (``--backend fused``:
  the kernels' plain twins).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_close, jax_params
from repro.core import rules_as_tree as jax_rules_as_tree, second_moment_savings as jax_savings, \
    table3_rules as jax_table3
from repro.core.slim_adam import slim_adam as jax_slim_adam
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.examples import diy_slim, quickstart

ROOT = Path(__file__).resolve().parents[1]
CUTOFF = 1.0


def test_quickstart_prints_the_jax_scripts_count_and_savings(capsys):
    want = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart.py")], capture_output=True, text=True,
                          check=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                                     "JAX_PLATFORMS": "cpu"}).stdout.splitlines()
    out = quickstart.run(device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == want[:2], (got, want)
    assert want[2].startswith("20 SlimAdam steps: loss ") and got[2].startswith("20 SlimAdam steps: loss ")
    assert len(out["losses"]) == 20 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("twin", [quickstart, diy_slim])
def test_twin_clis_run_to_the_end_on_the_cpu(twin, capsys):
    twin.main(["--device", "cpu", "--backend", "fused"])
    out = capsys.readouterr().out
    assert ("20 SlimAdam steps: loss" if twin is quickstart else "SlimAdam(SNR rules) final loss") in out


def test_quickstart_losses_from_the_jax_weights_match_make_train_step():
    jcfg, jparams, jmeta, arrays = jax_params(seed=0, arch="smollm_135m")
    tx = jax_slim_adam(3e-4, jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta), backend="jnp")
    data = JaxZipfLM(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=8))
    step = jax.jit(jax_make_train_step(jcfg, tx))
    params, opt, want = jparams, tx.init(jparams), []
    for i in range(3):
        params, opt, metrics = step(params, opt, {k: jnp.asarray(v) for k, v in data.batch(i).items()})
        want.append(float(metrics["loss"]))
    got = quickstart.run(device="cpu", params=params_from_numpy(arrays, "cpu"), steps=3)["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _jax_diy(probe_steps, snr_every, slim_steps):
    """examples/diy_slim.py's three steps through the JAX package's Trainer."""
    from repro.configs import get_reduced

    cfg = get_reduced("jamba_v01_52b")
    data = JaxZipfLM(JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))
    probe = JaxTrainer(cfg, "adam", 3e-3, data, JaxTrainerConfig(total_steps=probe_steps, log_every=20,
                                                                 measure_snr=True, snr_early_every=snr_every,
                                                                 backend="jnp"))
    probe.run()
    rules = probe.derive_slim_rules(cutoff=CUTOFF)
    slim = JaxTrainer(cfg, "slim_snr", 3e-3, data, JaxTrainerConfig(total_steps=slim_steps, log_every=20,
                                                                    backend="jnp"), rules=rules)
    return probe.snr.averaged(), rules, jax_savings(probe.params, probe.meta, rules), slim.run()


def test_diy_slim_twin_matches_the_jax_workflow(capsys):
    want_snr, want_rules, want_savings, want_final = _jax_diy(12, 4, 4)
    _, _, _, arrays = jax_params(seed=0, arch="jamba_v01_52b")
    got = diy_slim.run("jnp", "cpu", probe_steps=12, slim_steps=4, snr_every=4, log_every=20,
                       params=params_from_numpy(arrays, "cpu"))
    out = capsys.readouterr().out
    assert "time-averaged SNR per candidate dimension" in out and "SlimAdam(SNR rules) final loss" in out
    assert got["probe"].snr.steps == [4, 8, 12]
    assert list(got["snr"]) == list(want_snr)
    assert all(set(got["snr"][name]) == set(ks) for name, ks in want_snr.items())
    keys = [(name, k) for name, ks in want_snr.items() for k in ks]
    assert_close([got["snr"][n][k] for n, k in keys], [want_snr[n][k] for n, k in keys], 1e-4, "SNR table")
    near = {n for n, k in keys if abs(want_snr[n][k] - CUTOFF) <= 0.01 * CUTOFF}
    assert got["rules"].keys() == want_rules.keys()
    assert {k: r for k, r in got["rules"].items() if k not in near} == \
        {k: r for k, r in want_rules.items() if k not in near}
    assert any(r for k, r in got["rules"].items() if ".moe." in k)
    assert got["savings"] == want_savings
    np.testing.assert_allclose(got["final"]["loss"], want_final["loss"], rtol=1e-3)
