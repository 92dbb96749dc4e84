"""Data parallelism with ZeRO-1 in the port at DP 2 on the CPU: two gloo
ranks (``tests/torch_parallel_worker.py``), each on its half of the rows,
take two ``dpo_train_step``s and two ``sft_train_step``s.  Against the JAX
steps on the virtual ``data=2`` mesh (ZeRO-1 placement) and the port's one
process at the same global batch: every stat of each step, the adapter
after the steps and the AdamW moments made whole.

The rows hold different token counts (the SFT rows' labels, the DPO rows'
pads), so a mean of per-rank token means would fail.  Tolerances, f32:
stats 1e-5 relative (the grad norm 1e-4), moments 1e-4 of each leaf's
largest entry, adapters 5e-5 absolute (5 % of one update) after two
updates at lr 1e-3.  The one-process step tests hold adapters to 1e-6 with
a first update at lr 0; here both updates move them, and AdamW divides
each gradient element by its own root mean square, so an element whose
gradient is near zero moves by lr times a ratio that the order of the
data mean's sum can shift by a few per cent (measured: 5.7e-6 and 3.1e-5,
each at one element of 1024, the rest within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opadpo_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from opadpo_tpu.engine import dpo as jax_dpo
from opadpo_tpu.engine import sft as jax_sft
from opadpo_tpu.engine import train_state as jax_ts
from opadpo_tpu.parallel import MeshConfig, make_mesh, shard_pytree
from opadpo_tpu.parallel.mesh import batch_sharding
from opadpo_tpu.parallel.sharding import shard_train_state_zero1
from opadpo_torch import bridge
from opadpo_torch.engine import dpo as t_dpo
from opadpo_torch.engine import sft as t_sft
from opadpo_torch.engine import train_state as t_ts
from opadpo_torch.models.lora import make_trainable, named_leaves
from tests.torch_parallel_worker import launch
from tests.torch_parity import (
    JCFG32, dpo_batch, jax_lora, jax_params, to_np, torch_model,
)

SCALING = 2.0
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10)
PARAMS = jax_params()
LORA = jax_lora(1)
DPO = jax_dpo.DpoConfig(response_len=8, query_len=6, lora_scaling=SCALING)
SFT = jax_sft.SftConfig(lora_scaling=SCALING)


def sft_rows(b=4, lq=6, lr=9, seed=11):
    """Right-padded conversations whose rows hold 9, 7, 4 and 2 labelled
    tokens: rank 0's rows 16, rank 1's 6."""
    rng = np.random.default_rng(seed)
    v = JCFG32.llama.vocab_size
    length = lq + lr
    ids = rng.integers(5, v, (b, length)).astype(np.int64)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    labels = np.where(np.arange(length)[None] >= lq, ids, IGNORE_INDEX)
    for row, pads in enumerate((0, 2, 5, 7)):
        if pads:
            ids[row, -pads:] = 0
            labels[row, -pads:] = IGNORE_INDEX
    mask = ((ids != 0) | (labels != IGNORE_INDEX)).astype(np.int64)
    sz = JCFG32.vision.image_size
    images = rng.normal(size=(b, sz, sz, 3)).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "images": images}


def _dpo_rows():
    """Four rows with the JAX rollout (its CoPO masks) for both sides."""
    batch = dpo_batch(b=4)
    ref = jax_lora(2)
    roll = jax.jit(jax_dpo.rollout_score, static_argnums=(1, 2))(
        PARAMS, JCFG32, DPO, {"llama": ref["llama"]},
        {k: jnp.asarray(x) for k, x in batch.items()},
        jax.random.PRNGKey(3))
    return {**batch, **{k: np.asarray(x) for k, x in roll.items()}}


DPO_ROWS = _dpo_rows()
SFT_ROWS = sft_rows()
TREES = {"dpo": {"llama": LORA["llama"]}, "sft": LORA}
ROWS = {"dpo": DPO_ROWS, "sft": SFT_ROWS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    res = launch(2, [("dp_steps", dict(
        params=to_np(PARAMS), lora=to_np(LORA), dpo_batch=DPO_ROWS,
        sft_batch=SFT_ROWS, opt=OPT))], tmp_path_factory.mktemp("dp"),
        timeout=85)
    return [r[0] for r in res]


def _adam(opt_state):
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no AdamW state")


def _jax_steps(name):
    """Two JAX steps on the ``data=2`` mesh, ZeRO-1 placement."""
    mesh = make_mesh(MeshConfig(data=2, model=1), jax.devices()[:2])
    tx = jax_ts.make_optimizer(jax_ts.OptimizerConfig(**OPT))
    state = shard_train_state_zero1(
        jax_ts.TrainState.create(TREES[name], tx), mesh)
    batch = shard_pytree({k: jnp.asarray(x) for k, x in ROWS[name].items()},
                         {k: batch_sharding(mesh).spec for k in ROWS[name]},
                         mesh)
    if name == "dpo":
        step = jax.jit(jax_dpo.dpo_train_step, static_argnums=(3, 4, 5))
        args = (tx, JCFG32, DPO)
    else:
        step = jax.jit(jax_sft.sft_train_step, static_argnums=(3, 4, 5))
        args = (tx, JCFG32, SFT)
    stats = []
    for _ in range(2):
        state, st = step(state, PARAMS, batch, *args)
        stats.append({k: float(v) for k, v in st.items()})
    mu, nu = _adam(state.opt_state)
    return stats, to_np(state.params), [
        [g.numpy() for _, g in named_leaves(bridge.lora_from_jax(
            to_np(m), "cpu"))] for m in (mu, nu)]


def _port_one_process(name):
    model = torch_model(PARAMS)
    opt = t_ts.AdamW(t_ts.OptimizerConfig(**OPT))
    state = t_ts.TrainState.create(make_trainable(
        bridge.lora_from_jax(to_np(TREES[name]), "cpu")), opt.cfg)
    batch = bridge.tensors_from_jax(ROWS[name], "cpu")
    stats = []
    for _ in range(2):
        if name == "dpo":
            state, st = t_dpo.dpo_train_step(
                state, model, batch, opt,
                t_dpo.DpoConfig(response_len=8, query_len=6,
                                lora_scaling=SCALING))
        else:
            state, st = t_sft.sft_train_step(
                state, model, batch, opt, t_sft.SftConfig(
                    lora_scaling=SCALING))
        stats.append({k: float(v) for k, v in st.items()})
    return stats, bridge.lora_to_jax(state.params), [
        [m.numpy() for m in ms] for ms in (state.mu, state.nu)]


def _check(got, want, what):
    (g_stats, g_params, g_mom), (w_stats, w_params, w_mom) = got, want
    for step, (gs, ws) in enumerate(zip(g_stats, w_stats)):
        assert set(gs) == set(ws), what
        for key, ref in ws.items():
            rel = 1e-4 if key == "loss/grad_norm" else 1e-5
            np.testing.assert_allclose(gs[key], ref, rtol=rel,
                                       atol=rel * 1e-2,
                                       err_msg=f"{what} step {step} {key}")
    flat_g = dict(jax.tree_util.tree_leaves_with_path(g_params))
    for path, ref in jax.tree_util.tree_leaves_with_path(w_params):
        np.testing.assert_allclose(flat_g[path], np.asarray(ref), atol=5e-5,
                                   rtol=0, err_msg=f"{what} {path}")
    for gm, wm in zip(g_mom, w_mom):
        assert len(gm) == len(wm)
        for g, w in zip(gm, wm):
            np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                       rtol=0, err_msg=what)


@pytest.mark.parametrize("name", ["dpo", "sft"])
def test_dp2_zero1_steps_match_jax_and_one_process(world, name):
    """Both ranks' stats agree; the stats, the adapter and the whole
    moments match the JAX steps on ``data=2`` and the port's one process;
    some moment is split over the two ranks."""
    r0, r1 = world[0][name], world[1][name]
    assert r0["stats"] == r1["stats"]
    assert any(r0["split"])
    got = (r0["stats"], r0["params"], [r0["mu"], r0["nu"]])
    _check(got, _jax_steps(name), f"{name} against JAX")
    _check(got, _port_one_process(name), f"{name} against one process")
    moved = max(np.abs(np.asarray(a) - np.asarray(b)).max()
                for (_, a), (_, b) in zip(
                    jax.tree_util.tree_leaves_with_path(r0["params"]),
                    jax.tree_util.tree_leaves_with_path(
                        to_np(TREES[name]))))
    assert moved > 1e-4


def test_sft_rank_means_would_differ():
    """The rows' token counts make the mean of the two ranks' token means
    differ from the global token mean (so the case above can tell)."""
    valid = (SFT_ROWS["labels"][:, 1:] != IGNORE_INDEX).sum(axis=1)
    assert valid[:2].sum() != valid[2:].sum()
