"""Training the SSM family in the port, against the JAX package on the CPU,
at reduced falcon_mamba_7b (4 Mamba-1 layers, d_model 64, d_state 4, vocab
211, f32) from the JAX-initialised parameters carried across by
``repro_torch.convert``:

* every parameter's loss gradient on a ZipfLM batch matches ``jax.grad`` of
  the JAX loss (1e-5 of each gradient's largest magnitude: the scan's
  backward replays and sums in another order than the JAX custom VJP);
* 20 Table-3 SlimAdam steps give the JAX trainer's loss curve within 1e-3
  relative (f32 reassociation accumulates over the steps, as for gpt_small
  in ``test_torch_slice.py``), and the loss falls;
* an Adam run measuring SNR derives the same SlimAdam rules, the ``ssm_*``
  leaves among them;
* ``python -m repro_torch.launch.train --arch falcon_mamba_7b --reduced
  --device cpu`` trains.

On the CPU the scan's wrappers run their plain twins; the card's kernels
are held against those twins in ``test_torch_cuda.py`` and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import assert_close, flat_numpy, jax_params
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.models import transformer as jtf
from repro.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import table3_rules
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.launch.train import main as launch_main
from repro_torch.models import forward
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.loss import lm_loss

ARCH = "falcon_mamba_7b"
GRADS = 1e-5
DATA = dict(vocab_size=211, seq_len=32, global_batch=4, seed=5)
LR = 3e-3


def test_model_gradients_match_jax_grad():
    jcfg, jparams, _, arrays = jax_params(seed=0, arch=ARCH)
    cfg = get_reduced(ARCH)
    batch = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=3, seed=2)).batch(0)
    jgrads = jax.grad(lambda p: jax_lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                            jtf.forward)[0])(jparams)
    want = flat_numpy(jgrads)
    params = params_from_numpy(arrays, "cpu")
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = lm_loss(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, forward)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert list(grads) == list(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name                      # every leaf gets a gradient
        assert_close(g.numpy(), want[name], GRADS, name)
    ssm = [n for n in grads if ".ssm." in n]
    assert {n.rsplit(".", 1)[1] for n in ssm} == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
                                                  "a_log", "d_skip", "out_proj"}


def _pair(optimizer, steps, **tc_kw):
    """(JAX trainer, port trainer) after ``steps`` on reduced falcon_mamba_7b,
    from the same parameters and ZipfLM batches."""
    jcfg, _, _, arrays = jax_params(seed=0, arch=ARCH)
    jtr = JaxTrainer(jcfg, optimizer, LR, JaxZipfLM(JaxDataConfig(**DATA)),
                     JaxTrainerConfig(total_steps=steps, log_every=1, seed=0, backend="jnp", **tc_kw))
    jtr.run()
    ttr = Trainer(get_reduced(ARCH), optimizer, LR, ZipfLM(DataConfig(**DATA)),
                  TrainerConfig(total_steps=steps, log_every=1, seed=0, backend="fused", **tc_kw), device="cpu")
    ttr.model.load_params(params_from_numpy(arrays, "cpu"))
    ttr.run()
    return jtr, ttr


def test_table3_slim_loss_curve_matches_jax():
    jtr, ttr = _pair("slim", 20)
    want = [m["loss"] for m in jtr.metrics_log]
    got = [m["loss"] for m in ttr.metrics_log]
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    # Table 3 compresses the ssm_in/ssm_out/ssm_x/ssm_dt leaves
    rules = table3_rules(ttr.meta)
    assert {n.rsplit(".", 1)[1] for n, r in rules.items() if ".ssm." in n and r} == {"in_proj", "out_proj", "x_proj",
                                                                                   "dt_proj"}


def test_adam_snr_derives_the_same_rules_as_jax():
    jtr, ttr = _pair("adam", 10, measure_snr=True, snr_early_every=5)
    assert ttr.snr.steps == jtr.snr.steps == [5, 10]
    rules = ttr.derive_slim_rules()
    assert rules == jtr.derive_slim_rules()
    assert any(".ssm." in n for n in rules)


def test_launch_cli_trains_reduced_falcon_on_the_cpu(capsys):
    launch_main(["--arch", "falcon_mamba_7b", "--reduced", "--device", "cpu", "--steps", "3", "--seq", "16",
                 "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses)), out
    assert "done: 3 steps" in out
