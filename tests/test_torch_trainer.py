"""The port's Trainer host loop (mirrors tests/test_trainer.py): fit writes
its checkpoints, TensorBoard events and model_meta.json, keeps the remainder
batch, resumes bitwise, and chunked epochs equal per-epoch ones. The module
trains in place, so every run builds a fresh model from the same seed."""
import json

import pytest
import torch

from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler, RelobraloScaler
from porous_cfd_tpu_torch.train.trainer import Trainer, TrainerConfig, load_checkpoint

CFG = dict(nu=1e-3, d=10.0, f=1.0, fe_local_layers=[2, 8, 8],
           fe_global_layers=[8 + 5, 8, 16], seg_layers=[24, 8, 3],
           seg_dropout=[0.05, 0.0])
WEIGHTS = FixedLossScaler((1, 1, 1, 1, 1, 1, 10, 10, 10))


def tiny_model():
    return pipn_foam(**CFG, scalers=make_scalers(),
                     generator=torch.Generator().manual_seed(0), device="cpu")


def make_data(n_cases, seed=0):
    return make_foam_batch(n_cases, 24, 8, 4, seed=seed)


def params(state):
    return [p.detach().clone() for p in state.module.parameters()]


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_fit_writes_artifacts_and_load_checkpoint_restores(tmp_path):
    trainer = Trainer(tiny_model(), make_data(5), make_data(2, seed=1),
                      TrainerConfig(epochs=4, batch_size=2, logs_dir=str(tmp_path),
                                    name="exp", checkpoint_every=2),
                      loss_scaler=WEIGHTS, model_type="pipn")
    trainer.write_model_meta(24, 8, 4)
    state = trainer.fit()
    log_dir = tmp_path / "lightning_logs" / "exp"
    meta = json.loads((log_dir / "model_meta.json").read_text())
    assert meta["Model type"] == "pipn" and meta["Batch size"] == 2
    for name in ("model.ckpt", "best.ckpt", "checkpoint-epoch=2.ckpt",
                 "checkpoint-epoch=4.ckpt"):
        assert (log_dir / name).exists(), name
    assert list(log_dir.glob("events.out.tfevents.*"))
    assert state.step == 4 * trainer.steps_per_epoch

    restored, epoch = load_checkpoint(log_dir / "model.ckpt", tiny_model(),
                                      steps_per_epoch=trainer.steps_per_epoch)
    assert epoch == 4 and restored.step == state.step
    assert_same(params(restored), params(state))
    best, best_epoch = load_checkpoint(log_dir / "best.ckpt", tiny_model())
    assert 1 <= best_epoch <= 4 and best.step == best_epoch * trainer.steps_per_epoch


def test_remainder_batch_included(tmp_path):
    trainer = Trainer(tiny_model(), make_data(5), None,
                      TrainerConfig(epochs=1, batch_size=2, logs_dir=str(tmp_path),
                                    name="r"))
    assert trainer.full_steps == 2 and trainer.remainder == 1
    assert trainer.fit().step == 3  # 2 full + 1 remainder step


@pytest.mark.parametrize("scaler", ["fixed", "relobralo"])
def test_resume_matches_uninterrupted_bitwise(tmp_path, scaler):
    loss_scaler = WEIGHTS if scaler == "fixed" else RelobraloScaler(9)
    data = make_data(4)
    cfg = dict(epochs=6, batch_size=2, name="x", checkpoint_every=3)
    full = Trainer(tiny_model(), data, None,
                   TrainerConfig(logs_dir=str(tmp_path / "full"), **cfg),
                   loss_scaler=loss_scaler).fit()
    t_ab = Trainer(tiny_model(), data, None,
                   TrainerConfig(logs_dir=str(tmp_path / "ab"), **cfg),
                   loss_scaler=loss_scaler)
    t_ab.config.epochs = 3          # interrupted after epoch 3
    t_ab.fit()
    t_ab.config.epochs = 6
    ckpt = tmp_path / "ab" / "lightning_logs" / "x" / "checkpoint-epoch=3.ckpt"
    resumed = Trainer(tiny_model(), data, None,
                      TrainerConfig(logs_dir=str(tmp_path / "ab"), **cfg),
                      loss_scaler=loss_scaler).fit(resume_from=str(ckpt))
    assert resumed.step == full.step == 12
    assert_same(params(resumed), params(full))
    if scaler == "relobralo":
        torch.testing.assert_close(resumed.scaler_state.lambda_ema,
                                   full.scaler_state.lambda_ema, rtol=0, atol=0)


def test_chunked_epochs_match_per_epoch(tmp_path):
    data = make_data(4)
    states = {}
    for name, log_every in [("per-epoch", 1), ("chunked", 3)]:
        trainer = Trainer(tiny_model(), data, None,
                          TrainerConfig(epochs=6, batch_size=2, logs_dir=str(tmp_path),
                                        name=name, log_every=log_every,
                                        checkpoint_every=3))
        states[name] = trainer.fit()
        assert (tmp_path / "lightning_logs" / name / "checkpoint-epoch=3.ckpt").exists()
    assert states["chunked"].step == states["per-epoch"].step
    assert_same(params(states["chunked"]), params(states["per-epoch"]))


def test_resample_refreshes_dataset(tmp_path):
    calls = []

    def resample_fn(round_idx):
        calls.append(round_idx)
        return make_data(4, seed=1000 + round_idx)

    Trainer(tiny_model(), make_data(4), None,
            TrainerConfig(epochs=6, batch_size=2, logs_dir=str(tmp_path), name="x",
                          checkpoint_every=2, resample_every=2),
            resample_fn=resample_fn).fit()
    assert calls == [1, 2]
