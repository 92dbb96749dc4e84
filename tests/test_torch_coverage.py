"""Coverage of the JAX package by the port, read from the sources with
``ast`` (nothing of ``opadpo_tpu`` is imported).

For each module of ``opadpo_tpu/``:

- every public top-level function and class is defined (or assigned) at
  the top level of the same-path module of ``opadpo_torch/``, or is named
  in ``COUNTERPART`` (the port's name for it, elsewhere or under another
  name) or in ``NOT_CARRIED`` (TPU structure, with the reason);
- every config key its drivers read (``t.get("k")``, read as
  ``training.k``, and ``cfg.get_path("k")``) is read by the same-path port
  module, and every ``--flag`` is added there, or is in ``COUNTERPART``.

Every entry of the two maps still names something in the JAX source, and
every ``COUNTERPART`` target exists in the port (a flag's target adds the
flag).  ``ROADMAP.md``'s "Counterpart map" mirrors all of it, table for
table.
"""

import ast
import os
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "opadpo_tpu", ROOT / "opadpo_torch"

# JAX name -> the port's counterpart, "module.py:Name" or
# "module.py:Class.attribute"
COUNTERPART = {
    "engine/sampler.py:generate": "engine/sampler.py:Sampler.generate",
    "engine/train_state.py:make_optimizer": "engine/train_state.py:AdamW",
    "models/clip.py:init_params": "models/llava.py:init_params",
    "models/clip.py:forward": "models/clip.py:ClipVisionTower.forward",
    "models/llama.py:init_params": "models/llava.py:init_params",
    "models/llama.py:append_suffix_to_prompt_kv":
        "models/llama.py:fold_suffix_into_prompt_kv",
    "models/llava.py:LlavaModel": "models/llava.py:Llava",
    "models/projector.py:init_params": "models/llava.py:init_params",
    "models/projector.py:forward": "models/projector.py:Projector.forward",
    "ops/attention.py:set_fused_attention":
        "pipeline/runtime.py:check_fused_attention",
    "ops/attention.py:get_fused_attention":
        "pipeline/runtime.py:check_fused_attention",
    "ops/quant.py:is_quantized": "ops/quant.py:QuantLinear.bits",
    "ops/quant.py:is_quantized4": "ops/quant.py:QuantLinear.bits",
    "ops/quant.py:set_act_quant": "ops/quant.py:set_quant_mode",
    "ops/quant.py:get_act_quant": "ops/quant.py:QuantMode.act_bits",
    "ops/quant.py:get_act_outlier_cols":
        "ops/quant.py:QuantMode.outlier_cols",
    "ops/quant.py:get_act_bwd_int8": "ops/quant.py:QuantMode.bwd_int8",
    "parallel/sharding.py:param_partition_specs":
        "parallel/sharding.py:shard_module",
    "parallel/sharding.py:shard_pytree": "parallel/sharding.py:shard_module",
    "parallel/sharding.py:zero1_opt_state_specs":
        "parallel/sharding.py:zero1_slice",
    "parallel/sharding.py:shard_train_state_zero1":
        "engine/train_state.py:TrainState.create",
    "pipeline/runtime.py:maybe_init_multihost":
        "parallel/mesh.py:init_process_group",
    "pipeline/runtime.py:device_put_batch":
        "pipeline/runtime.py:batch_to_device",
    "eval/model_qa.py:--model-path": "eval/model_vqa.py:model_args",
    "eval/model_qa.py:--adapter-path": "eval/model_vqa.py:model_args",
    "eval/model_vqa_logit.py:--model-path": "eval/model_vqa.py:model_args",
    "eval/model_vqa_logit.py:--vision-path": "eval/model_vqa.py:model_args",
    "eval/model_vqa_logit.py:--adapter-path": "eval/model_vqa.py:model_args",
    "eval/model_vqa_science.py:--model-path":
        "eval/model_vqa.py:model_args",
    "eval/model_vqa_science.py:--vision-path":
        "eval/model_vqa.py:model_args",
    "eval/model_vqa_science.py:--adapter-path":
        "eval/model_vqa.py:model_args",
    "eval/run_all.py:--model-path": "eval/model_vqa.py:model_args",
    "eval/run_all.py:--vision-path": "eval/model_vqa.py:model_args",
    "eval/run_all.py:--adapter-path": "eval/model_vqa.py:model_args",
}

_STATIC = ("the static whole-sequence cache of the scanned TPU decode; "
           "the port decodes over the prompt KV and a suffix cache, as the "
           "JAX package's unrolled path does")
_SPLIT = ("the split cache over stacked [L, ...] layers for the TPU's "
          "scanned loop; the port runs the same split a layer at a time, "
          "as the JAX package's unrolled path does")
_STACKED = ("stacked [L, ...] weights to a per-layer list for the TPU "
            "decode; the port keeps one module per layer")
_SHARDING = ("a PartitionSpec / NamedSharding helper of the JAX mesh; a "
             "port rank holds its own rows and shards (parallel/)")

# JAX name -> why the port has no counterpart: TPU structure
NOT_CARRIED = {
    "engine/sampler.py:decode_loop": _STATIC,
    "models/llama.py:init_kv_cache": _STATIC,
    "models/llava.py:prefill": _STATIC,
    "models/llava.py:decode_step": _STATIC,
    "engine/sampler.py:decode_loop_split": _SPLIT,
    "models/llama.py:decode_forward_split": _SPLIT,
    "models/llava.py:decode_step_split": _SPLIT,
    "models/llama.py:unstack_layers": _STACKED,
    "models/llava.py:unstack_for_decode": _STACKED,
    "models/llama.py:fuse_for_inference": (
        "wq/wk/wv and w_gate/w_up fused into wider TPU matmuls; the port's "
        "linears stay apart"),
    "ops/attention.py:set_default_impl": (
        "the attn_impl switch between Pallas and XLA attention; a port "
        "wrapper chooses by its tensor's device"),
    "ops/attention.py:get_default_impl": (
        "the attn_impl switch between Pallas and XLA attention; a port "
        "wrapper chooses by its tensor's device"),
    "ops/attention.py:set_tp_mesh": (
        "the shard_map mesh of the TPU flash kernel; under tensor "
        "parallelism a port rank runs the kernels on its own heads"),
    "ops/attention.py:get_tp_mesh": (
        "the shard_map mesh of the TPU flash kernel; under tensor "
        "parallelism a port rank runs the kernels on its own heads"),
    "parallel/mesh.py:batch_spec": _SHARDING,
    "parallel/mesh.py:replicated_spec": _SHARDING,
    "parallel/mesh.py:batch_sharding": _SHARDING,
    "parallel/mesh.py:replicated_sharding": _SHARDING,
    "pipeline/runtime.py:enable_compilation_cache": (
        "XLA's persistent compilation cache; the port builds each kernel "
        "source once, under build/ (ops/_build.py)"),
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def public_names(tree: ast.Module) -> list:
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def top_level(tree: ast.Module) -> set:
    """Names a module defines, assigns or imports at its top level."""
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
    return out


def keys_and_flags(tree: ast.Module):
    """(config keys, flags) a module reads: ``t.get("k")`` as
    ``training.k``, ``x.get_path("k")`` as ``k``, and
    ``add_argument("--flag")``."""
    keys, flags = set(), set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.args):
            continue
        first = n.args[0]
        text = first.value if isinstance(first, ast.Constant) and \
            isinstance(first.value, str) else None
        if text is None:
            continue
        f = n.func
        if f.attr == "get" and isinstance(f.value, ast.Name) and \
                f.value.id == "t":
            keys.add("training." + text)
        elif f.attr == "get_path":
            keys.add(text)
        elif f.attr == "add_argument":
            flags.update(a.value for a in n.args if isinstance(a, ast.Constant)
                         and str(a.value).startswith("--"))
    return keys, flags


def _modules():
    out = {}
    for path in sorted(JAX.rglob("*.py")):
        rel = path.relative_to(JAX).as_posix()
        tree = _tree(path)
        names = public_names(tree)
        keys, flags = keys_and_flags(tree)
        if names or keys or flags:
            out[rel] = (names, sorted(keys), sorted(flags))
    return out


MODULES = _modules()


def _port(rel: str):
    path = PORT / rel
    return _tree(path) if path.exists() else None


def port_covers(rel: str):
    """(names, keys, flags) of the JAX module ``rel`` that its same-path
    port module has under the same name."""
    names, keys, flags = MODULES[rel]
    tree = _port(rel)
    if tree is None:
        return [], [], []
    have = top_level(tree)
    pkeys, pflags = keys_and_flags(tree)
    return ([n for n in names if n in have], [k for k in keys if k in pkeys],
            [f for f in flags if f in pflags])


@pytest.mark.parametrize("rel", sorted(MODULES))
def test_jax_module_has_its_counterparts(rel):
    names, keys, flags = MODULES[rel]
    same = port_covers(rel)
    mapped = set(COUNTERPART) | set(NOT_CARRIED)
    missing = [f"{rel}:{x}" for got, want in zip(same, (names, keys, flags))
               for x in want if x not in got and f"{rel}:{x}" not in mapped]
    assert not missing, f"no counterpart and no reason for {missing}"


def _jax_has(entry: str) -> bool:
    rel, name = entry.split(":", 1)
    if rel not in MODULES:
        return False
    names, keys, flags = MODULES[rel]
    return name in names or name in keys or name in flags


@pytest.mark.parametrize("entry", sorted(set(COUNTERPART) | set(NOT_CARRIED)))
def test_map_entry_names_the_jax_source_and_is_needed(entry):
    assert _jax_has(entry), f"{entry} is not in the JAX source any more"
    rel, name = entry.split(":", 1)
    assert name not in sum(port_covers(rel), []), \
        f"{entry} has the same name in the port now; drop it from the map"
    assert not (entry in COUNTERPART and entry in NOT_CARRIED)


def _self_attributes(cls: ast.ClassDef) -> set:
    return {t.attr for n in ast.walk(cls) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name) and t.value.id == "self"}


def _find(tree: ast.Module, dotted: str):
    """The node of ``Name`` or ``Class.member`` (a method, a field, or an
    attribute its methods set on ``self``), or None."""
    name, _, member = dotted.partition(".")
    node = next((n for n in tree.body if getattr(n, "name", None) == name),
                None)
    if node is None or not member:
        return node
    for n in node.body:
        if getattr(n, "name", None) == member or (
                isinstance(n, ast.AnnAssign)
                and getattr(n.target, "id", None) == member):
            return n
    return node if member in _self_attributes(node) else None


@pytest.mark.parametrize("entry", sorted(COUNTERPART))
def test_counterpart_exists_in_the_port(entry):
    target = COUNTERPART[entry]
    rel, dotted = target.split(":", 1)
    tree = _port(rel)
    assert tree is not None, f"{target}: no such port module"
    node = _find(tree, dotted)
    assert node is not None, f"{target}: not defined in the port"
    flag = entry.split(":", 1)[1]
    if flag.startswith("--"):
        assert flag in keys_and_flags(ast.Module(body=[node],
                                                 type_ignores=[]))[1], \
            f"{target} does not add {flag}"


def test_port_imports_nothing_of_the_jax_package_here():
    """The map is read from source text: this test module imports neither
    JAX nor the JAX package."""
    src = Path(__file__).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|opadpo_tpu)\b", src,
                         re.M)


def _roadmap_section() -> list:
    text = (ROOT / "ROADMAP.md").read_text().splitlines()
    start = next(i for i, line in enumerate(text)
                 if line.startswith("### Counterpart map"))
    end = next((i for i in range(start + 1, len(text))
                if text[i].startswith("#")), len(text))
    return text[start:end]


def _cells(line: str) -> list:
    return [c.strip() for c in line.strip().strip("|").split("|")]


def _ticked(cell: str) -> list:
    return re.findall(r"`([^`]+)`", cell)


def roadmap_tables():
    """(same-name names by module, keys and flags by module, the map's
    rows) as ROADMAP.md's counterpart map writes them."""
    same, read, mapped = {}, {}, {}
    for line in _roadmap_section():
        if not line.startswith("| `"):
            continue
        cells = _cells(line)
        head = _ticked(cells[0])[0]
        if len(cells) == 3:
            read[head] = (_ticked(cells[1]), _ticked(cells[2]))
        elif ":" in head:
            mapped[head] = cells[1]
        else:
            same[head] = _ticked(cells[1])
    return same, read, mapped


def test_roadmap_mirrors_the_map():
    same, read, mapped = roadmap_tables()
    want_same, want_read = {}, {}
    for rel in MODULES:
        names, keys, flags = port_covers(rel)
        if names:
            want_same[rel] = names
        if keys or flags:
            want_read[rel] = (keys, flags)
    assert same == want_same
    assert read == want_read
    want_map = {k: f"`{v}`" for k, v in COUNTERPART.items()}
    want_map.update({k: f"not carried over: {v}"
                     for k, v in NOT_CARRIED.items()})
    assert mapped == want_map
