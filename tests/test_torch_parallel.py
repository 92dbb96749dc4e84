"""The port's mesh, collectives and sharding rules (``opadpo_torch/parallel``)
in one process, against the JAX package's ``opadpo_tpu/parallel``:

- ``MeshConfig.resolve`` and its error; one process with ``model`` 2
  raises it (``mesh 0x2 != 1 devices``, the JAX message); the mesh of
  independent ranks (``group=False``) from ``RANK`` / ``WORLD_SIZE``;
- the shard of every decoder leaf (weights, int8 / int4 codes and scales,
  the LoRA factors) on each model rank equals the matching slice of the
  JAX ``param_partition_specs`` placement on the ``1 x 2`` virtual mesh
  (``shard_pytree``, then ``addressable_shards``), at bits 16, 8 and 4
  (bits 4 on the tiny model with 4 heads, whose ``wo`` row shards hold
  whole groups of 128; the tiny ``wo`` of 128 inputs is refused); the
  vision tower stays whole on every rank, where the JAX rules split its
  attention (the port's choice);
- a checkpoint read at ``model`` 2 (each decoder weight read, quantized
  and cut in turn) equals the whole model read, quantized and cut, at
  bits 16, 8 and 4, vision tower included;
- the ZeRO-1 axis against ``zero1_opt_state_specs``;
- the collectives are the identity over a group of one;
- speculative decode and the continuous slot pool, once refused on a
  tensor-parallel model, take one: the speculative suffix caches hold the
  rank's own heads (the two-rank runs are
  ``tests/test_torch_parallel_pool.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from opadpo_tpu.models import llava as jax_llava
from opadpo_tpu.ops.quant import quantize_params
from opadpo_tpu.parallel import (
    MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh,
    param_partition_specs, shard_pytree, zero1_opt_state_specs,
)
from opadpo_torch import bridge
from opadpo_torch.engine.continuous import ContinuousEngine
from opadpo_torch.engine.sampler import Sampler
from opadpo_torch.engine.sampling import SamplingConfig
from opadpo_torch.models import loader
from opadpo_torch.ops.quant import QuantLinear
from opadpo_torch.parallel import comm, sharding
from opadpo_torch.parallel import mesh as t_mesh
from opadpo_torch.pipeline import config, online_generation, runtime
from tests.torch_parallel_worker import tiny_f32
from tests.torch_parity import JCFG32, inputs, jax_lora, t, to_np


def _jcfg(heads):
    return dataclasses.replace(JCFG32, llama=dataclasses.replace(
        JCFG32.llama, num_heads=heads, num_kv_heads=heads))


def fake_mesh(model_rank: int, n: int = 2):
    """Model rank ``model_rank`` of a ``1 x n`` mesh with no process group
    (enough for the slicing rules)."""
    return t_mesh.Mesh(1, n, model_rank, t_mesh.Group(1, 0, (model_rank,)),
                       t_mesh.Group(n, model_rank, tuple(range(n))),
                       torch.device("cpu"))


@pytest.mark.parametrize("data,model,n", [(-1, 1, 8), (-1, 2, 8), (4, 2, 8),
                                          (2, 2, 4), (-1, 2, 1), (3, 2, 8)])
def test_mesh_config_resolves_as_jax(data, model, n):
    def run(cls):
        try:
            return cls(data=data, model=model).resolve(n)
        except ValueError as e:
            return str(e)
    got, want = run(t_mesh.MeshConfig), run(JaxMeshConfig)
    assert (got if isinstance(got, str) else (got.data, got.model)) == (
        want if isinstance(want, str) else (want.data, want.model))


def test_one_process_with_model_2_raises_the_resolve_error(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
        t_mesh.make_mesh(t_mesh.MeshConfig(model=2), "cpu")
    one = t_mesh.make_mesh(t_mesh.MeshConfig(), "cpu")
    assert (one.data, one.model, one.rank, one.tp) == (1, 1, 0, None)
    assert t_mesh.init_process_group("cpu") is None


def test_a_mesh_of_independent_ranks_needs_no_group(monkeypatch):
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    mesh = t_mesh.make_mesh(t_mesh.MeshConfig(), "cpu", group=False)
    assert (mesh.data, mesh.model, mesh.rank, mesh.data_rank,
            mesh.model_rank, mesh.tp) == (3, 1, 1, 1, 0, None)
    assert mesh.data_group.pg is None and mesh.model_group.pg is None
    with pytest.raises(ValueError, match="needs a process group"):
        t_mesh.make_mesh(t_mesh.MeshConfig(model=2), "cpu", group=False)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    one = t_mesh.make_mesh(t_mesh.MeshConfig(), "cpu", group=False)
    assert (one.data, one.model, one.rank) == (1, 1, 0)


def test_a_missing_local_device_raises(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
        t_mesh._set_cuda_device(1)


def _shard_of(x, mesh, r):
    dev = mesh.devices[0, r]
    return np.asarray([s for s in x.addressable_shards
                       if s.device == dev][0].data)


def _jax_shards(tree, mesh):
    placed = shard_pytree(tree, param_partition_specs(tree, mesh), mesh)
    return [jax.tree_util.tree_map(lambda x: _shard_of(x, mesh, r), placed)
            for r in range(2)]


def _check_linear(lin, leaf, i, name):
    if isinstance(leaf, dict):
        assert isinstance(lin, QuantLinear), name
        if "q4" in leaf:
            np.testing.assert_array_equal(lin.q.numpy(), leaf["q4"][i].T)
            np.testing.assert_array_equal(lin.scale.numpy(),
                                          leaf["scale"][i].T)
        else:
            np.testing.assert_array_equal(lin.q.numpy(), leaf["q"][i].T)
            np.testing.assert_array_equal(lin.scale.numpy(),
                                          leaf["scale"][i, 0])
    else:
        np.testing.assert_array_equal(lin.weight.numpy(), leaf[i].T,
                                      err_msg=name)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_shards_match_the_jax_placement(bits):
    """Every decoder leaf and LoRA factor of each model rank's shard."""
    heads = 4 if bits == 4 else 2
    jcfg = _jcfg(heads)
    params = jax_llava.init_params(jax.random.PRNGKey(0), jcfg)
    if bits != 16:
        params = quantize_params(params, bits=bits)
    lora = jax_lora(1, cfg=jcfg)
    mesh = jax_make_mesh(JaxMeshConfig(data=1, model=2), jax.devices()[:2])
    jp, jl = _jax_shards(params, mesh), _jax_shards(lora, mesh)
    full = to_np(params)
    for r in range(2):
        model = bridge.llava_from_jax(full, tiny_f32(heads), "cpu")
        sharding.shard_module(model, fake_mesh(r))
        lm, lp = model.llama, jp[r]["llama"]
        np.testing.assert_array_equal(lm.embed.numpy(), lp["embed"])
        np.testing.assert_array_equal(lm.lm_head.weight.numpy(),
                                      lp["lm_head"].T)
        for i, layer in enumerate(lm.layers):
            np.testing.assert_array_equal(layer.attn_norm.numpy(),
                                          lp["layers"]["attn_norm"][i])
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down"):
                _check_linear(getattr(layer, name), lp["layers"][name], i,
                              name)
        assert lm.cfg.num_heads == heads // 2
        # the port keeps the vision tower whole on every rank
        np.testing.assert_array_equal(
            model.vision.layers[0].wq.weight.numpy()
            if bits == 16 else model.vision.layers[0].wq.q.numpy(),
            (full["vision"]["layers"]["wq"][0].T if bits == 16
             else full["vision"]["layers"]["wq"]["q"][0].T))
        tl = sharding.shard_lora(
            bridge.lora_from_jax(to_np(lora), "cpu"), fake_mesh(r))
        ll = jl[r]["llama"]
        for i, entry in enumerate(tl["llama"]["layers"]):
            for name, fac in entry.items():
                for k in ("a", "b"):
                    np.testing.assert_array_equal(
                        fac[k].numpy(), ll["layers"][name][k][i].T,
                        err_msg=f"{name}/{k}")
        for k in ("a", "b"):
            np.testing.assert_array_equal(tl["llama"]["lm_head"][k].numpy(),
                                          ll["lm_head"][k].T)
        assert tl["llama"]["layers"][0]["wq"]["b"].shape[0] == \
            heads * 64 // 2


def test_an_int4_row_shard_of_half_a_group_is_refused():
    params = quantize_params(jax_llava.init_params(jax.random.PRNGKey(0),
                                                   JCFG32), bits=4)
    model = bridge.llava_from_jax(to_np(params), tiny_f32(), "cpu")
    with pytest.raises(ValueError, match="whole groups of 128"):
        sharding.shard_module(model, fake_mesh(0))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_a_checkpoint_read_cut_equals_the_whole_model_cut(bits, tmp_path,
                                                          monkeypatch):
    """``setup_model`` of a checkpoint on model rank r of 2 (each decoder
    weight read from the mapped files, quantized whole and cut before the
    next) holds exactly what the one-process ``setup_model`` holds once
    ``shard_module`` cuts it: every tensor, the vision tower's quantized
    linears included, each in a storage of its own size."""
    heads = 4 if bits == 4 else 2
    cfg = tiny_f32(heads)
    params = to_np(jax_llava.init_params(jax.random.PRNGKey(3),
                                         _jcfg(heads)))
    loader.save_llava_checkpoint(bridge.llava_from_jax(params, cfg, "cpu"),
                                 str(tmp_path / "m"), vision_in_dir=True)
    monkeypatch.setattr(runtime, "llava_config_from_hf", lambda _: cfg)
    for r in range(2):
        _, cut, mesh = runtime.setup_model(str(tmp_path / "m"), bits=bits,
                                           device="cpu", mesh=fake_mesh(r))
        _, whole, one = runtime.setup_model(str(tmp_path / "m"), bits=bits,
                                            device="cpu")
        assert (mesh.model_rank, one.model) == (r, 1)
        sharding.shard_module(whole, fake_mesh(r))
        got, want = cut.state_dict(), whole.state_dict()
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
            # no shard keeps the whole weight's storage alive
            assert got[k].untyped_storage().nbytes() == \
                got[k].numel() * got[k].element_size(), k
        if bits != 16:
            assert isinstance(cut.vision.layers[0].fc1, QuantLinear)
        assert cut.llama.cfg == whole.llama.cfg


@pytest.mark.parametrize("n_data", [2, 4])
def test_zero1_axis_matches_jax(n_data):
    shapes = [(4, 128), (352, 4), (3,), (6, 6), (5, 7), (2, 8, 4), ()]
    mesh = jax_make_mesh(JaxMeshConfig(data=n_data, model=1),
                         jax.devices()[:n_data])
    specs = zero1_opt_state_specs(
        {str(i): np.zeros(s, np.float32) for i, s in enumerate(shapes)},
        mesh)
    for i, shape in enumerate(shapes):
        spec = tuple(specs[str(i)])
        want = spec.index("data") if "data" in spec else None
        assert sharding.zero1_axis(shape, n_data) == want, shape
    assert sharding.zero1_axis((4, 128), 1) is None


def test_collectives_are_the_identity_over_a_group_of_one():
    comm.reset_counts()
    x = torch.randn(3, 4, requires_grad=True)
    one = t_mesh.Group(1, 0, (0,), None)
    for fn in (comm.copy_to_model, comm.reduce_from_model, comm.gather):
        assert fn(x, one) is x
    assert comm.copy_to_model(x, None) is x
    y = comm.all_reduce_flat([x.detach(), torch.ones(2)], one, mean=True)
    assert torch.equal(y[0], x.detach()) and torch.equal(y[1], torch.ones(2))
    assert comm.counts() == {}


def test_tensor_parallel_speculative_and_pool_refuse_item_8b(
        tmp_path, monkeypatch):
    """Speculative decode and the continuous pool on a tensor-parallel
    model, and ``continuous_slots`` with ``mesh.model`` 2, once refused,
    are taken: on model rank 0's shard of a ``1 x 2``
    mesh without a process group (its own head, no collective) the shared
    and per-row speculative loops decode, every suffix cache they allocate
    holds the rank's 1 of 2 heads, the pool is built, and the rollout with
    the pool fails only where one process cannot make the mesh."""
    from opadpo_torch.models import llama
    params = jax_llava.init_params(jax.random.PRNGKey(0), JCFG32)
    model = bridge.llava_from_jax(to_np(params), tiny_f32(), "cpu")
    sharding.shard_module(model, fake_mesh(0))
    ids, mask, images = inputs()
    sampling = SamplingConfig(greedy=True, max_new_tokens=4, eos_token_id=-1)
    shapes = []
    init = llama.init_suffix_cache

    def recording(cfg, batch, n, device):
        caches = init(cfg, batch, n, device)
        shapes.append(tuple(caches[0][0].shape))
        return caches

    monkeypatch.setattr(llama, "init_suffix_cache", recording)
    for advance in ("shared", "per_row"):
        with torch.inference_mode():
            out = Sampler(sampling, kv_bits=8, spec_k=2,
                          spec_advance=advance).generate(
                model, t(ids), t(mask), t(images))
        assert out.shape == (2, 4)
    hd = JCFG32.llama.head_dim
    assert shapes and all(s[0] == 2 and s[2:] == (1, hd) for s in shapes)
    eng = ContinuousEngine(model, sampling, max_batch=2, qlen=10)
    assert eng.sp_splice == 10 - 1 + JCFG32.vision.num_patches
    cfg = config.Config({
        "mesh": {"model": 2}, "debug": {"tiny": True},
        "training": {"output_dir": str(tmp_path), "device": "cpu",
                     "continuous_slots": 2}})
    with pytest.raises(ValueError, match="mesh 0x2 != 1 devices"):
        online_generation.run(cfg)
