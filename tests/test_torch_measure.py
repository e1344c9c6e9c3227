"""The on-card measurement script's CPU-side logic: which profiler kernel
names it counts as the flash kernel.  A kernel renamed without the regex
would land silently in "other"."""

import pytest

pytest.importorskip("torch")  # a checkout without torch still collects
from traceml_tpu_torch.dev.measure_main_path import kernel_group


@pytest.mark.parametrize(
    "name,group",
    [
        ("void (anonymous namespace)::flash_fwd_wgmma_kernel<64>(CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, __nv_bfloat16*, int, int, (anonymous namespace)::Strides, float)",
         "flash_attention_fwd"),
        ("void (anonymous namespace)::flash_fwd_simt_kernel<128>(float const*, float const*, "
         "float const*, float*, int, (anonymous namespace)::Strides, (anonymous namespace)::Strides, "
         "(anonymous namespace)::Strides, (anonymous namespace)::Strides, float)",
         "flash_attention_fwd"),
        ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "gemm"),
        ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma", "gemm"),
        ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda>",
         "elementwise_and_reductions"),
        ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)"
         "::TensorListMetadata<2>, at::native::(anonymous namespace)::BinaryOpListAlphaFunctor<float, 2, 2, 0>, "
         "std::plus<float>, float>", "elementwise_and_reductions"),
        ("void some_unknown_kernel<1>()", "other"),
    ],
)
def test_kernel_group(name, group):
    assert kernel_group(name) == group
