"""The port's multi-process layout (parallel/distributed.py) on the CPU:
tests/test_distributed.py's four tests mirrored -- the single-process no-op,
model rows inside a process, the regrouping of an interleaved enumeration,
and a train step over the grid make_multihost_mesh lays (its loss against
JAX's over the same layout, 1e-5 relative) -- and the backend choice from a
layout (gloo on the CPU or where two processes share a card, NCCL where
each has its own)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from umbrella_tpu.config import ModelConfig
from umbrella_tpu.models.llama import StaticModelArgs as JaxArgs
from umbrella_tpu.models.llama import init_llama_params as jax_init
from umbrella_tpu.parallel.distributed import make_multihost_mesh as jax_mesh
from umbrella_tpu.parallel.mesh import shard_params
from umbrella_tpu.training import draft_trainer as jdt
from umbrella_tpu_torch.models.convert import config_from, train_params_from_numpy
from umbrella_tpu_torch.models.llama import StaticModelArgs
from umbrella_tpu_torch.parallel import distributed
from umbrella_tpu_torch.parallel.distributed import GlobalDevice
from umbrella_tpu_torch.parallel.mesh import shard_train_params
from umbrella_tpu_torch.training import draft_trainer as tdt
from umbrella_tpu_torch.training.data_parallel import make_dp_train_step

torch.set_num_threads(1)  # several test processes share the cores (test_torch_batched.py)

CPU = torch.device("cpu")


def _hosts(n=8, per=4):
    """n devices of `per` a simulated host: ids are the cuda indices."""
    return [GlobalDevice(i // per, torch.device("cuda", i)) for i in range(n)]


def test_initialize_single_process_noop():
    assert distributed.initialize() is None  # num_processes None
    assert distributed.initialize(num_processes=1) is None  # <= 1: must not connect
    assert not dist.is_initialized() and distributed.span() is None
    assert distributed.process_count() == 1 and distributed.process_index() == 0


def test_multihost_mesh_tp_rows_stay_in_host():
    """Simulated 2 hosts x 4 devices: every model row lies within one host,
    the data axis spans both."""
    devices = _hosts()
    for model in (4, 2):
        grid = distributed.make_multihost_mesh(model_per_host=model, devices=devices,
                                               local_device_count=4)
        assert (len(grid), len(grid[0])) == (8 // model, model)
        for row in grid:
            assert len({d.process for d in row}) == 1, f"row straddles hosts: {row}"
        assert {row[0].process for row in grid} == {0, 1}
    with pytest.raises(ValueError, match="divide"):
        distributed.make_multihost_mesh(model_per_host=3, devices=devices, local_device_count=4)


def test_order_by_process_fixes_interleaved_enumeration():
    """Devices fed in process-interleaved order come back in contiguous
    per-process blocks, stable within each process."""
    interleaved = [GlobalDevice(i % 2, torch.device("cuda", i)) for i in range(8)]
    ordered = distributed.order_by_process(interleaved)
    assert [d.process for d in ordered] == [0] * 4 + [1] * 4
    assert [d.device.index for d in ordered] == [0, 2, 4, 6, 1, 3, 5, 7]
    grid = distributed.make_multihost_mesh(model_per_host=4, devices=interleaved,
                                           local_device_count=4)
    assert [[d.device.index for d in row] for row in grid] == [[0, 2, 4, 6], [1, 3, 5, 7]]


def test_train_step_over_multihost_mesh():
    """The data-across-hosts, model-within-host step runs on the grid
    make_multihost_mesh lays (here one process holds both rows), and its
    loss is JAX's over its own multihost mesh."""
    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
                      max_position_embeddings=128, eos_token_id=2)
    jp = jax_init(cfg, jax.random.PRNGKey(0), 128, jnp.float32, packed=False)
    batch = np.random.default_rng(0).integers(0, 256, (4, 32)).astype(np.int32)
    mesh = jax_mesh(model_per_host=4, devices=jax.devices(), local_device_count=4)
    jopt = jdt.make_optimizer(total_steps=10)
    jstep = jax.jit(jdt.make_train_step(JaxArgs.from_config(cfg), jopt))
    _, jloss = jstep(jdt.init_train_state(shard_params(jp, mesh), jopt),
                     jax.device_put(batch, NamedSharding(mesh, P("data", None))))

    grid = distributed.make_multihost_mesh(
        model_per_host=4, devices=[GlobalDevice(i // 4, CPU) for i in range(8)],
        local_device_count=4)
    rows = [[d.device for d in row] for row in grid]
    params = shard_train_params(train_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)), rows[0])
    state = tdt.init_train_state(params, tdt.make_optimizer(total_steps=10))
    step = make_dp_train_step(StaticModelArgs.from_config(config_from(cfg)), None, rows)
    state, loss = step(state, torch.from_numpy(batch))
    assert np.isfinite(float(loss)) and float(loss) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("layout,backend", [
    ([["cpu"], ["cpu"]], "gloo"),
    ([["cuda-a", "cuda-b"], ["cuda-a", "cuda-b"]], "gloo"),  # two ranks on one card
    ([["cuda-a", "cuda-b"], ["cuda-c", "cuda-d"]], "nccl"),
    ([["cuda-a"], ["cpu"]], "gloo"),
])
def test_backend_follows_the_layout(layout, backend):
    got, why = distributed.choose_backend(layout)
    assert got == backend and why


def test_parse_address():
    assert distributed.parse_address("localhost:1234") == ("localhost", 1234)
    assert distributed.parse_address("tcp://127.0.0.1:29500") == ("127.0.0.1", 29500)
    with pytest.raises(ValueError):
        distributed.parse_address("localhost")


class _Span:
    """A stand-in for this process's place on a two-process axis."""
    size, rank, calls = 2, 1, 0


def test_engine_devices_under_a_process_span(monkeypatch):
    """Under a group of 2, tensor_parallel 8 takes 4 shards a process (the
    CPU 4 times here); stages and expert shards stay in one process, as the
    JAX package keeps a pipeline on one host, so those keys raise."""
    from umbrella_tpu_torch.speculation.engine_common import split_devices

    monkeypatch.setitem(distributed._STATE, "span", _Span())
    assert split_devices("ckpt", CPU, tensor=8) == [CPU] * 4
    with pytest.raises(ValueError, match="split evenly"):
        split_devices("ckpt", CPU, tensor=3)
    for key in ("pipeline", "expert"):
        with pytest.raises(ValueError, match="one process"):
            split_devices("ckpt", CPU, **{key: 4})


def test_multihost_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from umbrella_tpu_torch.examples import multihost_demo, multihost_worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost_demo.shard_devices("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost_worker.default_devices(0, 2)
    assert multihost_demo.shard_devices("cpu") == ["cpu,cpu,cpu,cpu"] * 2
