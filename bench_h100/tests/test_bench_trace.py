"""The window's readings: the kernel classes, the busy union, the breakdown
and the per-layer readers on a window made by hand."""

import pytest

from bench_h100 import trace
from bench_h100.run import reader

NAMES = {
    "flash_fwd_kernel<128>": "attention",
    "void flash_bwd_dq_kernel<128>(Params)": "attention",
    "scatter_heads_kernel<128>": "attention",
    "pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>": "attention",
    "fmha_cutlassF_f16_aligned_64x64_rf_sm80": "attention",
    "decode_attn_multi_kernel<128, 1>": "decode_attn",
    "q8_tile_kernel": "quant_mm",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_i161616gemm_s8_"
    "forwardCompat_128x128_32x2_nn_align4>(Params)": "quant_mm",
    "void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x256_128x3"
    "_tn_align16>(Params)": "quant_mm",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
    "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas": "matmul",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>":
        "matmul",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN": "matmul",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>>": "other",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_classify_by_the_work_done(name):
    assert trace.classify(name) == NAMES[name]


def test_busy_union_and_merge():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert trace.busy_us(iv) == 25
    assert trace.merged(iv) == [[0, 15], [20, 30]]


class _Run:
    def __init__(self, window, work, kind="dpo", peak=0):
        self.window, self.work, self.kind = window, work, kind
        self.peak_bytes = peak


def _window():
    w = trace.Window(lambda: None, True)
    w.seconds = 1.0
    w.kernels = [("flash_fwd_kernel", 0.0, 1e5), ("q8_tile_kernel", 2e5, 4e5),
                 ("sm80_xmma_gemm_f32f32", 5e5, 6e5)]
    w.host = [("aten::mm", 1.5e5, 1.6e5), ("step", 0.0, 1e6)]
    w.span_ms["rollout_score"] = 250.0
    return w


def test_readers_on_a_window_by_hand():
    w = _window()
    wk = {"bf16": 989e12 * 0.1, "int8": 0.0, "bytes": 0.0,
          "attention.flops": 989e12 * 0.05, "attention.bytes": 0.0,
          "quant_mm.flops": 1979e12 * 0.1, "quant_mm.bytes": 0.0}
    run = _Run(w, wk, peak=2 * 10 ** 9)
    assert reader("idle_share.dpo")(run) == pytest.approx(60.0)
    assert reader("score_share.dpo")(run) == pytest.approx(25.0)
    assert reader("mfu.dpo")(run) == pytest.approx(10.0)
    assert reader("roofline.attention.dpo")(run) == pytest.approx(50.0)
    assert reader("roofline.quant_mm.dpo")(run) == pytest.approx(50.0)
    assert reader("peak_gb.dpo")(run) == pytest.approx(2.0)


def test_readers_with_nothing_to_read_return_none():
    w = _window()
    w.kernels = [("sm80_xmma_gemm_f32f32", 0.0, 1e5)]
    run = _Run(w, {"bf16": 1.0, "int8": 0.0, "bytes": 0.0,
                   "attention.flops": 1.0, "attention.bytes": 0.0,
                   "quant_mm.flops": 0.0, "quant_mm.bytes": 0.0})
    assert reader("roofline.attention.dpo")(run) is None
    assert reader("roofline.quant_mm.dpo")(run) is None
    assert reader("mfu.dpo")(_Run(w, {}, kind="sft")) is None


def test_breakdown_names_the_host_op_at_each_gap():
    b = _window().breakdown()
    assert b["device_ops"][0][0] == "q8_tile_kernel"
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(0.1)
    assert gaps["step"] == pytest.approx(0.1)
