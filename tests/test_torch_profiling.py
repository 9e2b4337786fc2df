"""The port's timers (``porous_cfd_tpu_torch/utils/profiling.py``) against
the JAX package's (``porous_cfd_tpu/utils/profiling.py``): the same calls
and counts; ``device_ms`` refuses the CPU; ``trace`` writes a trace."""
import numpy as np
import pytest
import torch

from porous_cfd_tpu.utils import profiling as jax_profiling
from porous_cfd_tpu_torch.utils import profiling


class Counter:
    def __init__(self, make):
        self.calls = 0
        self.make = make

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.make(*args, **kwargs)


@pytest.mark.parametrize("n,warmup", [(5, 1), (3, 0), (1, 2)])
def test_timed_calls_as_the_jax_one(n, warmup):
    import jax.numpy as jnp
    port = Counter(lambda x, scale=1.0: x * scale)
    ref = Counter(lambda x, scale=1.0: x * scale)
    dt, out = profiling.timed(port, torch.ones(3), n=n, warmup=warmup, scale=2.0)
    dt_ref, out_ref = jax_profiling.timed(ref, jnp.ones(3), n=n, warmup=warmup, scale=2.0)
    assert port.calls == ref.calls == n + warmup
    assert dt > 0 and dt_ref > 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_ref))


def test_steps_per_sec_steps_as_the_jax_one():
    import jax.numpy as jnp

    def make(add):
        def step(state, x):
            return state + add(x), {"m": add(x)}
        return step

    port = Counter(make(lambda x: x))
    ref = Counter(make(lambda x: x))
    rate, state = profiling.steps_per_sec(port, torch.zeros(()), torch.ones(()), n_steps=4)
    rate_ref, state_ref = jax_profiling.steps_per_sec(ref, jnp.zeros(()), jnp.ones(()),
                                                      n_steps=4)
    assert port.calls == ref.calls == 5
    assert float(state) == float(state_ref) == 5.0
    assert rate > 0 and rate_ref > 0


def test_timer_counts_as_the_jax_one():
    port, ref = profiling.Timer(), jax_profiling.Timer()
    for timer, value in ((port, torch.ones(2)), (ref, np.ones(2))):
        assert timer.mean == 0.0
        for i in range(3):
            timer.start()
            timer.stop(value if i else None)
    assert port.count == ref.count == 3
    assert port.mean == pytest.approx(port.total / 3) and port.total > 0


def test_sync_result_walks_nested_results():
    tree = {"a": [torch.ones(1), (torch.zeros(2), 3)], "b": None}
    profiling.sync_result(tree)          # CPU tensors: nothing to wait for
    profiling.sync_result(None)
    assert profiling._devices_of(tree, set()) == {torch.device("cpu")}


def test_device_ms_refuses_the_cpu(monkeypatch):
    calls = []
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_ms(lambda: calls.append(1), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_ms(lambda: calls.append(1))
    assert calls == []                   # it never times the host in its place


def test_trace_writes_a_trace_directory(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        torch.randn(16, 16) @ torch.randn(16, 16)
    files = list(log_dir.rglob("*.json")) + list(log_dir.rglob("*.json.gz"))
    assert files and files[0].stat().st_size > 0
