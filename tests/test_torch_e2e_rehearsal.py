"""The port's pipeline rehearsal (``opadpo_torch/tools/e2e_rehearsal.py``)
on the CPU.

- Its data helpers write what ``scripts/e2e_rehearsal.py``'s write (the
  JAX script loaded from its file): the prompt dataset row for row, the
  injected correction reports and the POPE questions and images byte for
  byte.
- ``--model tiny --device cpu`` runs the four stages and the POPE pass
  into ``tmp_path``: the record carries the JAX script's stage names,
  ``pope_num_examples`` equals the questions written, the projection check
  reads the bench records it is given, and stage 3's checkpoint and stage
  4's adapter lie where ``recipes/train_opa_dpo.sh`` and
  ``recipes/eval_all_metrics.sh`` look for them.
"""

import filecmp
import importlib.util
import json
import os

import pytest

from opadpo_torch.tools import e2e_rehearsal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = {"rollout_generation", "dataset_build", "opa_sft", "opa_dpo",
          "pope_eval"}


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_e2e_rehearsal", os.path.join(REPO, "scripts",
                                          "e2e_rehearsal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_prompt_dataset_rows_equal_the_jax_scripts(tmp_path, jax_script):
    from datasets import load_from_disk

    e2e_rehearsal._make_prompt_dataset(str(tmp_path / "port"), 3)
    jax_script._make_prompt_dataset(str(tmp_path / "jax"), 3)
    assert load_from_disk(str(tmp_path / "port")).to_list() == \
        load_from_disk(str(tmp_path / "jax")).to_list()


def test_injected_reports_equal_the_jax_scripts(tmp_path, jax_script):
    shards = {"step1_rank0.json": [
        {"query": "q0", "original_generate_response": "It is a cat."},
        {"query": "q1", "original_generate_response": ""}],
        "step2_rank0.json": [
        {"query": "q2", "original_generate_response": "Two dogs."}]}
    for name in ("port", "jax"):
        os.makedirs(tmp_path / name)
        for shard, recs in shards.items():
            with open(tmp_path / name / shard, "w") as f:
                json.dump(recs, f)
    e2e_rehearsal._inject_fake_reports(str(tmp_path / "port"))
    jax_script._inject_fake_reports(str(tmp_path / "jax"))
    for shard in shards:
        assert filecmp.cmp(tmp_path / "port" / shard,
                           tmp_path / "jax" / shard, shallow=False)
    rec = json.load(open(tmp_path / "port" / "step1_rank0.json"))[1]
    assert rec["original_generate_response"] == "placeholder resp"
    assert json.loads(rec["AI_json_report"])["sentence_1"]["score"] == 2


def test_pope_questions_equal_the_jax_scripts(tmp_path, jax_script):
    for name, mod in (("port", e2e_rehearsal), ("jax", jax_script)):
        mod._pope_questions(str(tmp_path / f"{name}.jsonl"),
                            str(tmp_path / f"{name}_img"), 3)
    assert filecmp.cmp(tmp_path / "port.jsonl", tmp_path / "jax.jsonl",
                       shallow=False)
    for i in range(3):
        assert filecmp.cmp(tmp_path / "port_img" / f"pope{i}.png",
                           tmp_path / "jax_img" / f"pope{i}.png",
                           shallow=False)


def test_tiny_rehearsal_runs_the_four_stages_and_pope(tmp_path):
    work, out = tmp_path / "work", tmp_path / "rec.json"
    bench = {"bench_decode.json": {"tool": "bench_decode",
                                   "tokens_per_sec": 10.0},
             "bench_train_sft.json": {"tool": "bench_train", "mode": "sft",
                                      "seconds_per_step": 1.0}}
    argv = []
    for name, rec in bench.items():
        (tmp_path / name).write_text(json.dumps(rec))
        argv += ["--bench-record", str(tmp_path / name)]
    assert e2e_rehearsal.main([
        "--device", "cpu", "--model", "tiny", "--n-prompts", "2",
        "--dpo-steps", "1", "--pope-questions", "3", "--workdir", str(work),
        "--out", str(out), *argv]) == 0
    rec = json.loads(out.read_text())
    assert set(rec["stage_seconds"]) == STAGES
    assert all(s > 0 for s in rec["stage_seconds"].values())
    assert rec["pope_num_examples"] == 3
    assert rec["pope_num_examples_by_split"] == [3, 3, 3]
    assert rec["dpo_steps"] == 1 and rec["total_seconds"] > 0
    assert set(rec["projection_check"]) == {"rollout_tokens_per_sec",
                                            "sft_seconds_per_step"}
    # two examples a row (the GT response and the corrected one), batch 1
    assert rec["ran"]["sft_micro_steps"] == 4
    # where the recipes look: POLICY_LORA_DIR is stage 3's
    # checkpoint-final/adapter_model/lora_policy, ADAPTER stage 4's
    # checkpoint-<N>/adapter_model/lora_policy
    assert rec["stage3_checkpoint"] == os.path.join("opa_out",
                                                    "checkpoint-final")
    assert os.path.isdir(work / "opa_out" / "checkpoint-final" /
                         "adapter_model" / "lora_policy")
    assert rec["stage4_adapter"] == os.path.join(
        "dpo_out", "checkpoint-1", "adapter_model", "lora_policy")
    assert os.path.isfile(work / rec["stage4_adapter"] /
                          "adapter_config.json")
    assert os.path.isfile(work / "dpo_out" / "completed")
