"""The port's copy of the reference-formulation baseline
(``porous_cfd_tpu_torch/tools/torch_baseline.py``) against the root script
(``tools/torch_baseline.py``, loaded by path): the same loss and updated
weights on the same weights and inputs; and the same-card ratio tool on the
CPU."""
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from porous_cfd_tpu_torch.tools import samehost_ratio, torch_baseline
from porous_cfd_tpu_torch.tools.pieces import Envelope

ROOT = Path(__file__).resolve().parents[1]
B, NI, NB, NOBS = 2, 30, 20, 12


@pytest.fixture(scope="module")
def root_script():
    spec = importlib.util.spec_from_file_location("root_torch_baseline",
                                                  ROOT / "tools/torch_baseline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the script reads its sizes from module constants
    mod.B, mod.NI, mod.NB, mod.NOBS, mod.DEV = B, NI, NB, NOBS, "cpu"
    return mod


def test_step_equals_the_root_scripts(root_script):
    torch.manual_seed(3)
    ref_model = root_script.Pipn()
    model = torch_baseline.Pipn()
    model.load_state_dict(ref_model.state_dict())
    ref_opt = torch.optim.Adam(ref_model.parameters(), lr=1e-3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    inputs = torch_baseline.make_inputs("cpu", B, NI, NB)
    for _ in range(2):
        ref_loss = root_script.step(ref_model, ref_opt, inputs[0].clone(), *inputs[1:])
        loss = torch_baseline.step(model, opt, inputs[0].clone(), *inputs[1:], n_obs=NOBS)
        assert loss == pytest.approx(ref_loss, rel=1e-6)
    for (name, p), (_, r) in zip(model.named_parameters(), ref_model.named_parameters()):
        torch.testing.assert_close(p, r, rtol=1e-6, atol=1e-7, msg=name)


def test_inputs_come_from_an_explicit_generator():
    state = torch.random.get_rng_state()
    a = torch_baseline.make_inputs("cpu", 1, 4, 4)
    b = torch_baseline.make_inputs("cpu", 1, 4, 4)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_baseline_and_samehost_ratio_on_the_cpu(capsys):
    line = torch_baseline.run(["--steps", "1"], device="cpu", shape=(B, NI, NB, NOBS))
    assert line["steps_per_sec"] > 0 and math.isfinite(line["loss"]) and line["card"] is None
    env = Envelope(cases=2, batch=2, n_int=24, n_bnd=16, n_obs=8)
    out = samehost_ratio.run(["--torch-steps", "1", "--port-steps", "2",
                              "--port-exact-steps", "1"], device="cpu", envelope=env)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    for key in ("torch_reference_steps_per_sec", "port_exact_autodiff_steps_per_sec",
                "port_default_steps_per_sec", "ratio_exact_formulation", "ratio_default_path"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    assert out["ratio_default_path"] == pytest.approx(
        out["port_default_steps_per_sec"] / out["torch_reference_steps_per_sec"])
    assert not any(k.startswith("jax_") for k in out)
