"""The slice: the JAX package's ``pipn_foam`` and the port's, with the JAX
parameters carried across by ``convert.params_from_flax``, on the same
``make_foam_batch`` batch. Compares the analytic derivative path
(``derivative_apply``), verbose and plain ``predict_batch`` and
``eval_batch``. Both sides run f32 on the CPU (JAX at "highest" matmul
precision, tests/conftest.py)."""
import jax
import numpy as np
import pytest
import torch

from porous_cfd_tpu.data import synthetic as jax_synthetic
from porous_cfd_tpu.models.pipn import pipn_foam as jax_pipn_foam
from porous_cfd_tpu.train.engine import make_optimizer, make_train_functions
from porous_cfd_tpu_torch.convert import params_from_flax
from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.pipelines.evaluation import evaluate
from porous_cfd_tpu_torch.train.engine import make_predict_functions

CFG = dict(nu=1489.4e-6, d=14000.0, f=17.11,
           fe_local_layers=[2, 16, 16], fe_global_layers=[16 + 5, 16, 32, 64],
           seg_layers=[64 + 16, 32, 32, 16, 3], seg_dropout=[0.05, 0.05, 0, 0])
B, NI, NB, NO = 2, 40, 16, 8
# Values (fields, errors): f32 on both sides, sums at most 80 wide.
V_TOL = dict(rtol=1e-5, atol=1e-5)


def d_tol(ref):
    """J, H and the residuals: products of derivative rules through every
    layer, with the 64- and 80-wide sums taken in another order."""
    return dict(rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def pair():
    jax_model = jax_pipn_foam(**CFG, scalers=jax_synthetic.make_scalers())
    fns = make_train_functions(jax_model, make_optimizer(jax_model, 1))
    jax_batch = jax_synthetic.make_foam_batch(B, NI, NB, NO,
                                              rng=np.random.default_rng(11))
    params = fns.init_state(jax_batch).params
    model = pipn_foam(**CFG, scalers=make_scalers(), device="cpu")
    params_from_flax(jax.tree_util.tree_map(np.asarray, params), model.module)
    batch = make_foam_batch(B, NI, NB, NO, rng=np.random.default_rng(11))
    return jax_model, fns, params, jax_batch, model, batch


def test_same_batch_in_both_packages(pair):
    _, _, _, jax_batch, _, batch = pair
    np.testing.assert_array_equal(batch.data.numpy(), np.asarray(jax_batch.data))
    for k, v in jax_batch.domain.items():
        np.testing.assert_array_equal(batch.domain[k].numpy(), np.asarray(v))


def test_derivative_apply_matches_jax(pair):
    jax_model, _, params, jax_batch, model, batch = pair
    ref = [np.asarray(a) for a in
           jax_model.derivative_apply(params, jax_batch, None, True)]
    with torch.no_grad():
        out = [a.numpy() for a in model.derivative_apply(batch)]
    assert out[0].shape == (B, NI + NB, 3)
    assert out[1].shape == out[2].shape == (B, NI, 3, 2)
    np.testing.assert_allclose(out[0], ref[0], **V_TOL)
    np.testing.assert_allclose(out[1], ref[1], **d_tol(ref[1]))
    np.testing.assert_allclose(out[2], ref[2], **d_tol(ref[2]))


def test_verbose_predict_matches_jax(pair):
    _, fns, params, jax_batch, model, batch = pair
    ref_pred, ref_extras = fns.predict_batch(params, jax_batch, True)
    pred, extras = make_predict_functions(model).predict_batch(batch, True)
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref_pred.data), **V_TOL)
    assert extras.labels == ref_extras.labels
    for name in ("Momentum", "div"):
        r = np.asarray(ref_extras[name])
        np.testing.assert_allclose(extras[name].numpy(), r, **d_tol(r))


def test_plain_predict_and_eval_match_jax(pair):
    _, fns, params, jax_batch, model, batch = pair
    port = make_predict_functions(model)
    pred = port.predict_batch(batch)
    ref = fns.predict_batch(params, jax_batch, False)
    assert pred.labels == ref.labels
    np.testing.assert_allclose(pred.data.numpy(), np.asarray(ref.data), **V_TOL)
    np.testing.assert_allclose(port.eval_batch(batch).numpy(),
                               np.asarray(fns.eval_batch(params, jax_batch)),
                               **V_TOL)


def test_evaluate_matches_jax_common_data(pair):
    """The evaluation core batches the cases and extracts the same per-case
    errors and residual fields as the JAX pipeline's get_common_data."""
    from types import SimpleNamespace

    from porous_cfd_tpu.pipelines.evaluation import get_common_data
    from porous_cfd_tpu.train.engine import gather_cases

    _, fns, params, jax_batch, model, batch = pair
    ev = evaluate(model, batch, 1, make_scalers())
    assert len(ev.predictions) == B and ev.inference_time > 0
    for i in range(B):
        case = gather_cases(jax_batch, np.array([i]))
        pred, extras = fns.predict_batch(params, case, True)
        ref = get_common_data(
            SimpleNamespace(normalizers=jax_synthetic.make_scalers()),
            pred.numpy(), case.numpy(), extras.numpy())
        for key, r in ref.items():
            got = ev.results[key][i:i + 1]
            tol = d_tol(r) if "momentum" in key or "divergence" in key else V_TOL
            np.testing.assert_allclose(got, r, err_msg=key, **tol)
