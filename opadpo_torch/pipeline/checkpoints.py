"""Checkpoint directory contract + save/resume.  Port of
``opadpo_tpu/pipeline/checkpoints.py``, with ``torch.save`` where the JAX
package writes orbax checkpoints.

    output_dir/
      checkpoint-<N>/
        adapter_model/lora_policy/   <- PEFT adapter (adapter_model.bin
                                        + adapter_config.json)
        adapter_full.pt              <- the whole trainable adapter tree
        optimizer.pt                 <- AdamW moments, accumulator, counts
        trainer_state.json
      completed                      <- marker file

Discovery scans the ``checkpoint-N`` directories and the ``completed``
marker (reference ``utils/lora_utils.py:31-47``); resume parses the step
from the directory name and fast-forwards the data loader.  The rollout
stage resumes from its ``step{N}_rank{R}.json`` shards (``find_max_step``).

Over a mesh every rank takes part in gathering the adapter (its split
``b`` leaves over the model group) and the ZeRO-1 moments (over the data
group, then the model group), and global rank 0 writes them whole: the
files are those of a one-process run, so a run resumes at any world size.
Every rank reads and keeps its own parts.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple

import torch

from opadpo_torch.engine.train_state import TrainState, whole_moments
from opadpo_torch.models.loader import load_peft_adapter, save_peft_adapter
from opadpo_torch.models.lora import named_leaves
from opadpo_torch.parallel import comm
from opadpo_torch.parallel.sharding import model_sharded, unshard_lora

ADAPTER_MODEL_DIR = "adapter_model"
COMPLETED_MARKER = "completed"
_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def get_last_checkpoint(output_dir: str) -> Tuple[Optional[str], bool]:
    """(latest checkpoint dir | None, training_completed)."""
    if not os.path.isdir(output_dir):
        return None, False
    completed = os.path.exists(os.path.join(output_dir, COMPLETED_MARKER))
    best_step, best_dir = -1, None
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best_dir = os.path.join(output_dir, name)
    return best_dir, completed


def parse_checkpoint_step(checkpoint_dir: str) -> int:
    m = _CKPT_RE.match(os.path.basename(os.path.normpath(checkpoint_dir)))
    return int(m.group(1)) if m else 0


def mark_completed(output_dir: str) -> None:
    with open(os.path.join(output_dir, COMPLETED_MARKER), "w") as f:
        f.write("done\n")


def _host(tensors):
    return None if tensors is None else [t.detach().cpu() for t in tensors]


def _whole(tensors, state: TrainState, mesh, zero1: bool):
    """A list of per-leaf tensors as a one-process run holds them: ZeRO-1
    parts joined over the data group (``zero1``; else, the accumulator,
    averaged over it) and model-split leaves gathered."""
    if tensors is None or mesh is None:
        return tensors
    leaves = [t for _, t in named_leaves(state.params)]
    if zero1:
        tensors = whole_moments(tensors, leaves, state.parts, mesh.data_group)
    else:
        tensors = comm.all_reduce_flat(tensors, mesh.data_group, mean=True)
    return [comm.gather(t, mesh.model_group, dim=0) if s else t
            for t, s in zip(tensors, state.sharded)]


def save_train_state(ckpt_dir: str, state: TrainState, lora_cfg,
                     adapter_name: str = "lora_policy",
                     extra: Optional[dict] = None, mesh=None) -> None:
    """Save the adapter and the optimizer state.

    The PEFT ``adapter_model/<name>/`` holds the decoder's adapter (the
    format the reference's eval stack loads); ``adapter_full.pt`` holds the
    whole trainable tree (vision-tower and projector parts too) and is what
    ``restore_train_state`` reads; ``optimizer.pt`` the AdamW moments, the
    gradient accumulator and the counts.  With ``mesh``, every rank must
    call it; global rank 0 writes."""
    params = state.params if mesh is None else unshard_lora(state.params,
                                                            mesh)
    mu = _whole(state.mu, state, mesh, True)
    nu = _whole(state.nu, state, mesh, True)
    acc = _whole(state.acc, state, mesh, False)
    if mesh is None or mesh.is_main:
        os.makedirs(ckpt_dir, exist_ok=True)
        save_peft_adapter(params, os.path.join(ckpt_dir, ADAPTER_MODEL_DIR,
                                               adapter_name), lora_cfg)
        torch.save({path: t.detach().cpu()
                    for path, t in named_leaves(params)},
                   os.path.join(ckpt_dir, "adapter_full.pt"))
        torch.save({"mu": _host(mu), "nu": _host(nu), "acc": _host(acc),
                    "count": state.count, "mini_step": state.mini_step,
                    "step": state.step},
                   os.path.join(ckpt_dir, "optimizer.pt"))
        if extra is not None:
            with open(os.path.join(ckpt_dir, "trainer_state.json"),
                      "w") as f:
                json.dump(extra, f, indent=2)
    if mesh is not None:
        comm.barrier(mesh.world_group)


def _local(t: torch.Tensor, path: str, part, mesh, zero1: bool):
    """This rank's part of a whole saved tensor of leaf ``path``."""
    if mesh is None:
        return t
    if mesh.model > 1 and model_sharded(path):
        n = t.shape[0] // mesh.model
        t = t.narrow(0, mesh.model_rank * n, n)
    if zero1 and part is not None:
        t = t.narrow(*part)
    return t


@torch.no_grad()
def restore_train_state(ckpt_dir: str, state: TrainState, llama_cfg,
                        adapter_name: str = "lora_policy",
                        mesh=None) -> TrainState:
    """Restore the adapter and the optimizer into the template ``state``,
    in place (each tensor keeps its device and dtype), and return it.
    Without ``adapter_full.pt`` the decoder layers' adapter comes from the
    PEFT directory, the template's other parts kept.  With ``mesh`` each
    rank keeps its parts of the whole saved tensors."""
    full = os.path.join(ckpt_dir, "adapter_full.pt")
    leaves = named_leaves(state.params)
    parts = state.parts or [None] * len(leaves)
    if os.path.exists(full):
        saved = torch.load(full, map_location="cpu", weights_only=True)
        if set(saved) != {p for p, _ in leaves}:
            raise ValueError(f"{full}: adapter entries differ from the "
                             "template's")
    else:
        lora = load_peft_adapter(
            os.path.join(ckpt_dir, ADAPTER_MODEL_DIR, adapter_name),
            llama_cfg, dtype=torch.float32, device="cpu")
        saved = dict(named_leaves({"llama": lora["llama"]}))
    for path, t in leaves:
        if path in saved:
            t.copy_(_local(saved[path], path, None, mesh, False))
    opt = torch.load(os.path.join(ckpt_dir, "optimizer.pt"),
                     map_location="cpu", weights_only=True)
    for dst, src, zero1 in ((state.mu, opt["mu"], True),
                            (state.nu, opt["nu"], True),
                            (state.acc, opt["acc"], False)):
        if (dst is None) != (src is None):
            raise ValueError("gradient accumulation differs from the "
                             "checkpoint's")
        for (path, _), part, d, s in zip(leaves, parts, dst or [],
                                         src or []):
            d.copy_(_local(s, path, part, mesh, zero1))
    state.count, state.mini_step, state.step = (
        opt["count"], opt["mini_step"], opt["step"])
    return state


def find_max_step(rollout_dir: str, rank: Optional[int] = None) -> int:
    """The last rollout step written as a ``step{N}_rank{R}.json`` shard
    (0 if none; reference generator.py:126-140).  With ``rank`` only that
    rank's shards count, so a restarted rank redoes its own missing steps
    whatever the other ranks reached."""
    if not os.path.isdir(rollout_dir):
        return 0
    suffix = r"\d+" if rank is None else str(int(rank))
    pattern = re.compile(r"^step(\d+)_rank" + suffix + r"\.json$")
    steps = [int(m.group(1)) for m in map(pattern.match,
                                          os.listdir(rollout_dir)) if m]
    return max(steps, default=0)
