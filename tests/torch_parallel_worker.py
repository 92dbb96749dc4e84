"""One rank of the port's multi-process CPU tests (``tests/test_torch_parallel*.py``).

The parent writes a pickled spec (a list of ``(case, kwargs)`` with numpy
inputs) and starts one process per rank with ``launch``; each process
joins the gloo group from ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``, runs every case in order (the cases make their meshes from
the one group) and writes ``rank{R}.pt`` for the parent to compare.  This
module imports neither JAX nor the JAX package, as the port may not.
"""

import dataclasses
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(world: int, cases: list, tmp_path, timeout: float = 80.0,
           env: dict = None) -> list:
    """Run ``cases`` on ``world`` ranks (subprocesses, one thread each) ->
    each rank's results, in rank order."""
    spec = os.path.join(str(tmp_path), "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump(cases, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        e = {k: v for k, v in os.environ.items()
             if k not in ("OUTPUT_DIR", "MODEL_DIR", "DATA_DIR", "IMAGE_DIR",
                          "POLICY_LORA_DIR", "API_KEY", "API_KEY0",
                          "API_NUM")}
        e.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=ROOT + os.pathsep + e.get("PYTHONPATH", ""),
                 OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", spec,
             str(tmp_path)], cwd=ROOT, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err[-4000:]}"
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------

def tiny_f32(num_heads: int = 2):
    """``LlavaConfig.tiny()`` in f32, with ``num_heads`` heads of 64."""
    from opadpo_torch.models.llava import LlavaConfig
    t = LlavaConfig.tiny()
    return LlavaConfig(
        dataclasses.replace(t.llama, dtype=torch.float32,
                            num_heads=num_heads, num_kv_heads=num_heads),
        dataclasses.replace(t.vision, dtype=torch.float32),
        dataclasses.replace(t.projector, dtype=torch.float32))


def _mesh(model: int):
    from opadpo_torch.parallel.mesh import MeshConfig, make_mesh
    return make_mesh(MeshConfig(model=model), "cpu")


def _model(params, mesh, num_heads=2):
    from opadpo_torch import bridge
    from opadpo_torch.parallel import sharding
    model = bridge.llava_from_jax(params, tiny_f32(num_heads), device="cpu")
    return sharding.shard_module(model, mesh)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy()


def case_tp_forward(params, lora, ids, mask, images, labels, ent_w,
                    num_heads=2, scaling=2.0):
    """TP 2: the gathered logits, ``chunked_logprobs`` (with entropy) over
    the split vocabulary and the gradient of ``sum(lp) + 0.1 sum(ent *
    ent_w)`` with respect to the adapter, each split leaf gathered."""
    from opadpo_torch import bridge
    from opadpo_torch.models import llava
    from opadpo_torch.models.lora import make_trainable, named_leaves
    from opadpo_torch.ops.logprobs import chunked_logprobs
    from opadpo_torch.parallel import comm, sharding
    mesh = _mesh(2)
    model = _model(params, mesh, num_heads)
    lt = make_trainable(sharding.shard_lora(
        bridge.lora_from_jax(lora, "cpu"), mesh))
    ids, mask, images, labels = map(_t, (ids, mask, images, labels))
    with torch.no_grad():
        logits = llava.forward(model, ids, mask, images, lora=lt,
                               lora_scaling=scaling, remat=False)["logits"]
    comm.reset_counts()
    hidden = llava.forward(model, ids, mask, images, lora=lt,
                           lora_scaling=scaling, return_hidden=True)["hidden"]
    lp, ent = chunked_logprobs(
        hidden, model.llama.lm_head.weight, labels.long(), -100,
        with_entropy=True, head_lora=lt["llama"]["lm_head"],
        lora_scaling=scaling, tp=model.llama.tp, chunk_size=100)
    leaves = named_leaves(lt)
    grads = torch.autograd.grad(lp.sum() + 0.1 * (ent * _t(ent_w)).sum(),
                                [t for _, t in leaves])
    grads = {p: _np(comm.gather(g, mesh.model_group, 0)
                    if sharding.model_sharded(p) else g)
             for (p, _), g in zip(leaves, grads)}
    return {"logits": _np(logits), "lp": _np(lp), "ent": _np(ent),
            "grads": grads, "counts": comm.counts()}


def case_tp_sampler(params, ids, mask, images, runs):
    """TP 2 greedy tokens of each ``(kv_bits, chunk, max_new)`` run."""
    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.sampling import SamplingConfig
    mesh = _mesh(2)
    model = _model(params, mesh)
    ids, mask, images = map(_t, (ids, mask, images))
    out = {}
    for kv, chunk, n in runs:
        s = Sampler(SamplingConfig(greedy=True, max_new_tokens=n,
                                   eos_token_id=-1), kv_bits=kv, chunk=chunk)
        with torch.inference_mode():
            out[(kv, chunk, n)] = _np(s.generate(model, ids, mask, images))
    return out


def case_dp_steps(params, lora, dpo_batch, sft_batch, opt, scaling=2.0):
    """DP 2 with ZeRO-1: two ``dpo_train_step``s from ``lora`` (decoder
    part) and two ``sft_train_step``s from ``lora`` (all parts), each rank
    on its half of the rows -> per-step stats, the adapter after the steps
    and the moments, made whole."""
    from opadpo_torch import bridge
    from opadpo_torch.engine import dpo, sft
    from opadpo_torch.engine.train_state import (
        AdamW, OptimizerConfig, TrainState, whole_moments,
    )
    from opadpo_torch.models.lora import make_trainable, named_leaves
    mesh = _mesh(1)
    model = _model(params, mesh)

    def half(batch):
        b = next(iter(batch.values())).shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        return bridge.tensors_from_jax(
            {k: v[rows] for k, v in batch.items()}, "cpu")

    out = {}
    for name, batch, tree in (
            ("dpo", dpo_batch, {"llama": lora["llama"]}),
            ("sft", sft_batch, lora)):
        o = AdamW(OptimizerConfig(**opt), mesh)
        state = TrainState.create(
            make_trainable(bridge.lora_from_jax(tree, "cpu")), o.cfg, mesh)
        local, stats = half(batch), []
        for _ in range(2):
            if name == "dpo":
                state, st = dpo.dpo_train_step(
                    state, model, local, o,
                    dpo.DpoConfig(response_len=8, query_len=6,
                                  lora_scaling=scaling))
            else:
                state, st = sft.sft_train_step(
                    state, model, local, o, sft.SftConfig(
                        lora_scaling=scaling))
            stats.append({k: float(v) for k, v in st.items()})
        leaves = [t for _, t in named_leaves(state.params)]
        out[name] = {
            "stats": stats,
            "params": bridge.lora_to_jax(state.params),
            "mu": [_np(m) for m in whole_moments(state.mu, leaves,
                                                 state.parts,
                                                 mesh.data_group)],
            "nu": [_np(m) for m in whole_moments(state.nu, leaves,
                                                 state.parts,
                                                 mesh.data_group)],
            "split": [p is not None for p in state.parts]}
    return out


def _f32_patches():
    """The tiny f32 model from the checkpoint directory and f32 adapters
    (the config reader defaults to the 7B, the adapter loader to bf16)."""
    from opadpo_torch.models import loader
    from opadpo_torch.pipeline import opadpo_train, runtime
    runtime.llava_config_from_hf = lambda _: tiny_f32()
    opadpo_train.load_peft_adapter = functools.partial(
        loader.load_peft_adapter, dtype=torch.float32)


def case_stage4(cfg):
    """``opadpo_train.train`` of ``cfg`` (a plain dict)."""
    from opadpo_torch.parallel import comm
    from opadpo_torch.pipeline import config, opadpo_train
    _f32_patches()
    comm.reset_counts()
    timer = opadpo_train.train(config.Config(cfg))
    return {"history": [e["name"] for e in timer.history],
            "counts": comm.counts()}


class _StubService:
    """A GPT-4V service that answers every call with a report built from
    the audited answer, counting the calls."""

    model = "stub"
    calls = 0

    def call_llm_with_messages(self, messages):
        _StubService.calls += 1
        text = messages[1]["content"][1]["text"]
        answer = text.split("Answer to audit: ")[1].split("\n")[0]
        return json.dumps({"sentence_1": {
            "copied_content": answer, "score": 2,
            "rewritten_content": f"Fixed {len(answer)} chars."}})


def case_stages12(cfg):
    """``online_generation.run`` of ``cfg`` with the stub service and a
    dummy key -> the service's calls and the rows this rank sampled."""
    from opadpo_torch.pipeline import config, online_generation
    _f32_patches()
    os.environ["API_KEY"] = "dummy"
    online_generation.get_api_service = \
        lambda rank=0, cache_path="": _StubService()
    timer = online_generation.run(config.Config(cfg))
    return {"calls": _StubService.calls,
            "rows": sum(e.get("rows", 0) for e in timer.history)}


def _drain(eng, requests) -> list:
    """``requests`` [(ids, mask, image)] through ``eng`` -> each one's
    tokens, in request order."""
    rids = [eng.add_request(*r) for r in requests]
    done = {}
    while eng.has_work():
        done.update(eng.step())
    return [np.asarray(done[r]) for r in rids]


def case_tp_pool(params, requests, runs, max_batch=2, seg_len=2, max_new=4):
    """TP 2: the slot pool's greedy tokens over ``requests`` for each
    ``(kv_bits, spec_k)`` run, with the collectives each run made."""
    from opadpo_torch.engine.continuous import ContinuousEngine
    from opadpo_torch.engine.sampling import SamplingConfig
    from opadpo_torch.parallel import comm
    mesh = _mesh(2)
    model = _model(params, mesh)
    sampling = SamplingConfig(greedy=True, max_new_tokens=max_new,
                              eos_token_id=-1, pad_token_id=0)
    out = {}
    for kv, spec_k in runs:
        comm.reset_counts()
        eng = ContinuousEngine(model, sampling, max_batch=max_batch,
                               qlen=len(requests[0][0]), seg_len=seg_len,
                               kv_bits=kv, spec_k=spec_k)
        out[(kv, spec_k)] = {"tokens": _drain(eng, requests),
                             "counts": comm.counts()}
    return out


def case_tp_spec(params, ids, mask, images, runs, max_new=6):
    """TP 2: the speculative Sampler's tokens for each ``(kv_bits,
    advance, top_k)`` run (greedy at ``top_k`` 0, else top-k sampling from
    a generator seeded 3 on every rank), with the shapes of every suffix
    cache the run allocated."""
    from opadpo_torch.engine.sampler import Sampler
    from opadpo_torch.engine.sampling import SamplingConfig
    from opadpo_torch.models import llama
    mesh = _mesh(2)
    model = _model(params, mesh)
    ids, mask, images = map(_t, (ids, mask, images))
    init = llama.init_suffix_cache
    out = {}
    for kv, advance, top_k in runs:
        shapes = []

        def recording(cfg, batch, n, device):
            caches = init(cfg, batch, n, device)
            shapes.append(tuple(caches[0][0].shape))
            return caches

        sampling = SamplingConfig(greedy=not top_k, top_k=top_k,
                                  max_new_tokens=max_new, eos_token_id=-1)
        gen = torch.Generator().manual_seed(3)
        llama.init_suffix_cache = recording
        try:
            with torch.inference_mode():
                toks = Sampler(sampling, kv_bits=kv, spec_k=3,
                               spec_advance=advance).generate(
                    model, ids, mask, images, gen)
        finally:
            llama.init_suffix_cache = init
        out[(kv, advance, top_k)] = {"tokens": _np(toks), "shapes": shapes}
    return out


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    with open(spec_path, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for i, (name, kwargs) in enumerate(cases):
        results[i] = globals()[f"case_{name}"](**kwargs)
    rank = int(os.environ["RANK"])
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
