"""The port's profiler summary (`leanyolo_tpu_torch/utils/profiling.py`) and
`python -m leanyolo_tpu_torch.tools.profile_step`, on the CPU.

What is held:
- `capture_trace` / `summarize_trace` / `format_table` on a small CPU
  workload (the CPU operators' plane, as the JAX utility falls back to the
  CPU backend's ops), and profile_step end to end at yolov10n 64 px, batch 2,
  fp32, `--device cpu`, in both modes, with its JSON keys (JAX's);
- the family rule on real demangled CUDA kernel names, recorded from a trace
  of the port's serving and training steps on an H100: each of the port's
  eight kernels is a family of its own;
- the card's parsing path on hand-written Chrome traces with `"kernel"`
  events: device time is the kernels' own, overlap counted once, host
  events ignored; a trace with CUDA activity but no kernel record raises,
  as does one with no event of its plane, so no step reads as 0 ms;
- the parser against JAX's `tools/profile_step.py::parse_args`.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from leanyolo_tpu_torch.tools import profile_step
from leanyolo_tpu_torch.utils.profiling import (CPU_PLANE, _family, capture_trace, format_table,
                                                summarize_trace)
from tools import profile_step as jprofile_step

# The port's kernels as families (their launch counters' names beside).

PORT_KERNELS = {
    "stem_tc_kernel": "stem",
    "dw7x7_kernel": "dw7x7",
    "topk_kernel": "topk",
    "s2d_wgmma_kernel": "s2dconv",
    "gemm_kernel": "bmm",
    "argmax_kernel": "argmax",
    "nms_kernel": "nms",
    "mpbwd_vec_kernel": "mpbwd",
}
# Kernel names as a trace of the port's steps on an NVIDIA H100 recorded them
# (profile_step --mode infer/train, yolov10s 640 bf16 batch 32; every name of
# the port's kernels, one or a few of each library family's), with the family
# each must form.
REAL_NAMES = {
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous namespace)::Opaqu'
     'eType<4u>, unsigned int, 3, 64, 64>(at::native::(anonymous namespace)::OpaqueType<4u>*, at::native::'
     '(anonymous namespace)::CatArrInputTensorMetadata<at::native::(anonymous namespace)::OpaqueType<4u>, '
     'unsigned int, 64, 64>, at::native::(anonymous namespace)::TensorSizeStride<unsigned int, 4u>, int, u'
     'nsigned int)': 'CatArrayBatchedCopy',
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::(anonymous n'
     'amespace)::OpaqueType<2u>, unsigned int, 4, 128, 1, 8>(at::native::(anonymous namespace)::OpaqueType'
     '<2u>*, at::native::(anonymous namespace)::CatArrInputTensorMetadata<at::native::(anonymous namespace'
     ')::OpaqueType<2u>, unsigned int, 128, 1>, at::native::(anonymous namespace)::TensorSizeStride<unsign'
     'ed int, 4u>, int, unsigned int)': 'CatArrayBatchedCopy_alignedK_contig',
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous namesp'
     'ace)::OpaqueType<2u>, unsigned int, 2, 128, 1, 16, 8>(char*, at::native::(anonymous namespace)::CatA'
     'rrInputTensorMetadata<at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 128, 1>, at::'
     'native::(anonymous namespace)::TensorSizeStride<unsigned int, 4u>, int, unsigned int)': 'CatArrayBatchedCopy_vectorized',
    '_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolutionINS1_11threadblock22ImplicitGe'
     'mmMultistageINS_4gemm9GemmShapeILi64ELi128ELi32EEENS4_52Conv2dWgradOutputGradientTileAccessIteratorO'
     'ptimizedINS_11MatrixShapeILi64ELi32EEENS_10bfloat16_tENS_9transform29PitchLinearWarpRakedThreadMapIN'
     'S_16PitchLinearShapeILi64ELi32EEELi128ENSF_ILi8ELi4EEELi8EEENS_12AlignedArrayISC_Li8ELi16EEEEENSD_11'
     'threadblock25RegularTileAccessIteratorISB_SC_NS_6layout40ColumnMajorTensorOpMultiplicandCongruousILi'
     '16ELi64EEELi1ESI_Li16EEELNS_4arch14CacheOperation4KindE0ENS4_48Conv2dWgradActivationTileAccessIterat'
     'orOptimizedINSA_ILi32ELi128EEESC_NSE_INSF_ILi128ELi32EEELi128ESH_Li8EEESK_EENSN_ISW_SC_NSO_37RowMajo'
     'rTensorOpMultiplicandCongruousILi16ELi64EEELi0ESY_Li16EEELSU_0ENS6_11threadblock9MmaPolicyINS6_4warp'
     '11MmaTensorOpINS7_ILi32ELi64ELi32EEESC_SQ_SC_S11_fNSO_8RowMajorENS15_17MmaTensorOpPolicyINSS_3MmaINS'
     '7_ILi16ELi8ELi16EEELi32ESC_S18_SC_NSO_11ColumnMajorEfS18_NSS_13OpMultiplyAddEEENSA_ILi1ELi1EEEEELi1E'
     'Lb0EbEENSA_ILi0ELi0EEES1I_Li1EEELi6EbEENS_8epilogue11threadblock8EpilogueIS8_S1H_Li1ENS1M_22Predicat'
     'edTileIteratorINS1M_26OutputTileOptimalThreadMapINS1M_15OutputTileShapeILi128ELi8ELi2ELi1ELi1EEENS1Q'
     '_ILi1ELi4ELi1ELi1ELi4EEELi128ELi4ELi32EEEfLb0ENSO_9NoPermuteELb0EEENS1L_4warp24FragmentIteratorTenso'
     'rOpIS17_S1B_fNS_5ArrayIfLi4ELb1EEES18_EENS1W_20TileIteratorTensorOpIS17_S1B_fS18_EENS1M_18SharedLoad'
     'IteratorINS1T_18CompactedThreadMapEfLi16EEENS1L_6thread17LinearCombinationIfLi4EffLNS26_9ScaleType4K'
     'indE0ELNS_15FloatRoundStyleE2EEENSA_ILi0ELi8EEELi2ELi1EEENS13_30GemmIdentityThreadblockSwizzleILi4EE'
     'ELNS1_8OperatorE2ENS1_17Conv2dProblemSizeELNS1_9GroupModeE0EEEEEvNT_6ParamsE': 'Kernel',
    'void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_128x64_64x6_nt_align8>(cutlass_8'
     '0_tensorop_bf16_s16816gemm_relu_bf16_128x64_64x6_nt_align8::Params)': 'Kernel2',
    'void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::_cuda_scatter_fill_internal_'
     'kernel<at::native::OpaqueType<8>, long>::operator()<at::native::TensorAssign>(at::TensorIterator&, a'
     't::native::OpaqueType<8>, long, long, long, at::native::TensorAssign const&)::{lambda(int)#1}>(int, '
     'at::native::_cuda_scatter_fill_internal_kernel<at::native::OpaqueType<8>, long>::operator()<at::nati'
     've::TensorAssign>(at::TensorIterator&, at::native::OpaqueType<8>, long, long, long, at::native::Tens'
     'orAssign const&)::{lambda(int)#1})': '_scatter_gather_elementwise_kernel',
    'void (anonymous namespace)::argmax_kernel<__nv_bfloat16, true>(ArgmaxLevels, int, int, int, bool, vo'
     'id*, bool, int*)': 'argmax_kernel',
    'conv2d_c1_k1_nhwc_specialized': 'conv2d_c1_k1_nhwc_specialized',
    'dgrad2d_c1_k1_nhwc_specialized': 'dgrad2d_c1_k1_nhwc_specialized',
    'void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<float, 4, at::na'
     'tive::templates::cuda::uniform_and_transform<float, float, at::CUDAGeneratorImpl*, at::native::templ'
     'ates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDA'
     'GeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#'
     '1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_kernel<at:'
     ':CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}:'
     ':operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1})::{lambda(curandStatePhilox'
     '4_32_10*)#2}, at::native::(anonymous namespace)::distribution_nullary_kernel<float, float, float4, a'
     't::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_and_transform<float, float, at::CUDAGene'
     'ratorImpl*, at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBa'
     'se&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operat'
     'or()() const::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::native::templa'
     'tes::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAG'
     'eneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1'
     '})::{lambda(curandStatePhilox4_32_10*)#2}, at::native::templates::cuda::uniform_kernel<at::CUDAGener'
     'atorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator('
     ')() const::{lambda()#2}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGen'
     'eratorImpl*, at::native::templates::cuda::uniform_and_transform<float, float, at::CUDAGeneratorImpl*'
     ', at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, doubl'
     'e, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() con'
     'st::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::native::templates::cuda:'
     ':uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorIm'
     'pl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1})::{lambd'
     'a(curandStatePhilox4_32_10*)#2} const&, at::native::templates::cuda::uniform_kernel<at::CUDAGenerato'
     'rImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()()'
     ' const::{lambda()#2}::operator()() const::{lambda(float)#1})::{lambda(int, float)#1}>(long, at::Phil'
     'oxCudaState, at::native::templates::cuda::uniform_and_transform<float, float, at::CUDAGeneratorImpl*'
     ', at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, doubl'
     'e, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() con'
     'st::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::native::templates::cuda:'
     ':uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorIm'
     'pl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1})::{lambd'
     'a(curandStatePhilox4_32_10*)#2}, at::native::(anonymous namespace)::distribution_nullary_kernel<floa'
     't, float, float4, at::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_and_transform<float, '
     'float, at::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(a'
     't::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{'
     'lambda()#2}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*,'
     ' at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double'
     ', double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() cons'
     't::{lambda(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}, at::native::templates::cuda::uniform_k'
     'ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lam'
     'bda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1}>(at::TensorIterato'
     'rBase&, at::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_and_transform<float, float, at:'
     ':CUDAGeneratorImpl*, at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorI'
     'teratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2'
     '}::operator()() const::{lambda(float)#1}>(at::TensorIteratorBase&, at::CUDAGeneratorImpl*, at::nativ'
     'e::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, '
     'at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda'
     '(float)#1})::{lambda(curandStatePhilox4_32_10*)#2} const&, at::native::templates::cuda::uniform_kern'
     'el<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDAGeneratorImpl*)::{lambda'
     '()#1}::operator()() const::{lambda()#2}::operator()() const::{lambda(float)#1})::{lambda(int, float)'
     '#1})': 'distribution_elementwise_grid_stride_kernel',
    'void (anonymous namespace)::dw7x7_kernel<__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, '
     '__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int, bool)': 'dw7x7_kernel',
    'void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::(anonymou'
     's namespace)::where_kernel_impl(at::TensorIterator&)::{lambda()#1}::operator()() const::{lambda()#11'
     '}::operator()() const::{lambda(bool, float, float)#1}>(at::TensorIteratorBase&, at::native::(anonymo'
     'us namespace)::where_kernel_impl(at::TensorIterator&)::{lambda()#1}::operator()() const::{lambda()#1'
     '1}::operator()() const::{lambda(bool, float, float)#1} const&)::{lambda(int)#1}>(int, at::native::gp'
     'u_kernel_impl_nocast<at::native::(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::{lam'
     'bda()#1}::operator()() const::{lambda()#11}::operator()() const::{lambda(bool, float, float)#1}>(at:'
     ':TensorIteratorBase&, at::native::(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::{la'
     'mbda()#1}::operator()() const::{lambda()#11}::operator()() const::{lambda(bool, float, float)#1} con'
     'st&)::{lambda(int)#1})': 'elementwise_kernel',
    'void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_cuda_out(c10::Scal'
     'ar const&, c10::Scalar const&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const::{'
     'lambda()#4}::operator()() const::{lambda(long)#1}>(int, at::native::arange_cuda_out(c10::Scalar cons'
     't&, c10::Scalar const&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const::{lambda('
     ')#4}::operator()() const::{lambda(long)#1}, function_traits<at::native::arange_cuda_out(c10::Scalar '
     'const&, c10::Scalar const&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const::{lam'
     'bda()#4}::operator()() const::{lambda(long)#1}>::result_type*)': 'elementwise_kernel_with_index',
    'void sm90::gemm_kernel<128, 0, 1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 cons'
     't*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<128, 0, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 cons'
     't*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<128, 1, 1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 cons'
     't*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<128, 1, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 cons'
     't*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<128, 3, 1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 cons'
     't*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<128, 3, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 cons'
     't*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<64, 1, 1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const'
     '*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<64, 1, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const'
     '*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<64, 3, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const'
     '*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<80, 1, 1>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const'
     '*, int, int, int)': 'gemm_kernel',
    'void sm90::gemm_kernel<80, 1, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16 const'
     '*, int, int, int)': 'gemm_kernel',
    'void at::native::index_elementwise_kernel<128, 4, at::native::flip_kernel_impl<at::native::OpaqueTyp'
     'e<1> >(at::TensorIterator&)::{lambda(int)#1}>(long, at::native::flip_kernel_impl<at::native::OpaqueT'
     'ype<1> >(at::TensorIterator&)::{lambda(int)#1})': 'index_elementwise_kernel',
    'void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_kernel<xmma__5x_cudnn::implicit_ge'
     'mm::wgrad_indexed::Warp_specialized_params<xmma__5x_cudnn::Grid_constant_params> >(xmma__5x_cudnn::i'
     'mplicit_gemm::wgrad_indexed::Warp_specialized_params<xmma__5x_cudnn::Grid_constant_params>, bool)': 'init_device_workspace_kernel',
    'std::enable_if<true, void>::type internal::gemvx::kernel<int, int, float, float, float, float, true,'
     ' true, true, false, 6, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, c'
     'ublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGe'
     'mvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float co'
     'nst>, cublasGemvTensorStridedBatched<float>, float>)': 'kernel',
    'void at::native::lpnorm_cleanup<float, (at::native::NormType)1, float, true, float>(float const*, at'
     '::native::TensorListAddresses, int)': 'lpnorm_cleanup',
    'void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16, int>(c10::BFloat16 cons'
     't*, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, i'
     'nt, c10::BFloat16*, long*)': 'max_pool_forward_nhwc',
    'void (anonymous namespace)::mpbwd_vec_kernel<__nv_bfloat16, 5>(__nv_bfloat16 const*, __nv_bfloat16 c'
     'onst*, __nv_bfloat16*, int, int, int, int, int, int, int)': 'mpbwd_vec_kernel',
    'void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace):'
     ':TensorListMetadata<1>, at::native::(anonymous namespace)::BinaryOpScalarFunctor<float, 1, 1, 0>, st'
     'd::multiplies<float>, float>(at::native::(anonymous namespace)::TensorListMetadata<1>, at::native::('
     'anonymous namespace)::BinaryOpScalarFunctor<float, 1, 1, 0>, std::multiplies<float>, float)': 'multi_tensor_apply_kernel',
    'void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, (cudnnKernelDataType_t)0>(int, '
     'int, int, int, int, int, int, int, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, float, '
     'float, cudnn::reduced_divisor, cudnn::reduced_divisor, cudnn::reduced_divisor)': 'nhwcAddPaddingKernel',
    'void (anonymous namespace)::nms_kernel<float, true>((anonymous namespace)::Args<float>)': 'nms_kernel',
    'void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, at::native::func_wrapper_'
     't<c10::BFloat16, at::native::sum_functor<c10::BFloat16, float, c10::BFloat16>::operator()(at::Tensor'
     'Iterator&)::{lambda(float, float)#1}>, unsigned int, c10::BFloat16, 4, 8> >(at::native::ReduceOp<c10'
     '::BFloat16, at::native::func_wrapper_t<c10::BFloat16, at::native::sum_functor<c10::BFloat16, float, '
     'c10::BFloat16>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, c10::BFloa'
     't16, 4, 8>)': 'reduce_kernel',
    '(anonymous namespace)::wg::s2d_wgmma_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat1'
     '6 const*, __nv_bfloat16*, int, int, int, int, int, int, long long, long long)': 's2d_wgmma_kernel',
    'sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_stage4_warpsize2x2'
     'x1_g1_tensor16x8x16_t1r3s3_execute_kernel__5x_cudnn': 'sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_stage4_warpsize2x2x1_g1_tensor16x8x16_t1r3s3_execute_kernel__5x_cudnn',
    'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_warpgroupsize1x1'
     'x1_g1_execute_segment_k_off_kernel__5x_cudnn': 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn',
    'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1'
     'x1_g1_execute_segment_k_off_kernel__5x_cudnn': 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn',
    'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_warpgroupsize1x1x'
     '1_g1_execute_segment_k_off_kernel__5x_cudnn': 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn',
    'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_warpgroupsize1x1x1'
     '_g1_execute_segment_k_off_kernel__5x_cudnn': 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn',
    'void (anonymous namespace)::softmax_warp_backward<float, float, float, 4, true, false>(float*, float'
     ' const*, float const*, int, int, int, bool const*)': 'softmax_warp_backward',
    'void (anonymous namespace)::softmax_warp_forward<float, float, float, 4, true, false>(float*, float '
     'const*, int, int, int, bool const*, int, bool)': 'softmax_warp_forward',
    'void cublasLt::splitKreduce_kernel<32, 16, int, __nv_bfloat16, __nv_bfloat16, float, __nv_bfloat16, '
     'false, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true, false, false, false>(cublasLt::cublasSplit'
     'KParams<float>, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, __nv_bfloat16*, float co'
     'nst*, float const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, void*, long, float*,'
     ' int*, float*, float*, float const*, float const*, float const*, float const*, float const*)': 'splitKreduce_kernel',
    'void (anonymous namespace)::stem_tc_kernel<32, 64, unsigned char>(unsigned char const*, uint4 const*'
     ', __nv_bfloat16 const*, uint4 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int)': 'stem_tc_kernel',
    'void (anonymous namespace)::topk_kernel<__nv_bfloat16, unsigned int>(__nv_bfloat16 const*, int, int,'
     ' bool, int, bool, bool, bool, int, long long, __nv_bfloat16*, int*, unsigned int*)': 'topk_kernel',
    'void (anonymous namespace)::topk_kernel<float, unsigned long>(float const*, int, int, bool, int, boo'
     'l, bool, bool, int, long long, float*, int*, unsigned long*)': 'topk_kernel',
    'void at::native::unrolled_elementwise_kernel<at::native::BinaryFunctor<float, float, float, at::nati'
     've::binary_internal::DivFunctor<float> >, std::array<char*, 3ul>, 4, TrivialOffsetCalculator<2, unsi'
     'gned int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<2>, at::native'
     '::memory::StoreWithCast<1> >(int, at::native::BinaryFunctor<float, float, float, at::native::binary_'
     'internal::DivFunctor<float> >, std::array<char*, 3ul>, TrivialOffsetCalculator<2, unsigned int>, Tri'
     'vialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<2>, at::native::memory::Stor'
     'eWithCast<1>)': 'unrolled_elementwise_kernel',
    'void at::native::(anonymous namespace)::upsample_nearest2d_backward_out_frame<c10::BFloat16, float, '
     '&at::native::nearest_neighbor_bw_compute_source_index>(c10::BFloat16 const*, unsigned long, unsigned'
     ' long, unsigned long, unsigned long, unsigned long, unsigned long, c10::BFloat16*, float, float)': 'upsample_nearest2d_backward_out_frame',
    'void at::native::(anonymous namespace)::upsample_nearest2d_nhwc_out_frame<c10::BFloat16, &at::native'
     '::nearest_neighbor_compute_source_index>(c10::BFloat16 const*, c10::BFloat16*, unsigned long, unsign'
     'ed long, unsigned long, unsigned long, unsigned long, float, float, unsigned long)': 'upsample_nearest2d_nhwc_out_frame',
    'void at::native::vectorized_elementwise_kernel<2, at::native::(anonymous namespace)::launch_clamp_sc'
     'alar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::{lambda()#'
     '1}::operator()() const::{lambda()#4}::operator()() const::{lambda(long)#1}, std::array<char*, 2ul> >'
     '(int, at::native::(anonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c'
     '10::Scalar, at::native::detail::ClampLimits)::{lambda()#1}::operator()() const::{lambda()#4}::operat'
     'or()() const::{lambda(long)#1}, std::array<char*, 2ul>)': 'vectorized_elementwise_kernel',
    'wgrad2d_c1_k1_nhwc': 'wgrad2d_c1_k1_nhwc',
    'wgrad2d_c1_k1_nhwc_reduce': 'wgrad2d_c1_k1_nhwc_reduce',
    'nvjet_tst_128x160_64x5_1x2_h_bz_NNT': 'nvjet_tst_128x160_64x5_1x2_h_bz_NNT',
    'sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgrou'
     'psize1x1x1_g1_execute_segment_k_on_kernel__5x_cudnn': 'sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_on_kernel__5x_cudnn',
    'sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_warpgroupsize1x1'
     'x1_g1_execute_segment_k_off_kernel__5x_cudnn': 'sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn',
    'sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_exec'
     'ute_kernel__5x_cublas': 'sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas',
}


def _write_trace(path, events, devices=({"id": 0, "name": "NVIDIA H100 80GB HBM3"},)):
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "deviceProperties": list(devices), "traceEvents": events}, f)


def _kernel(name, ts, dur, device=0, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": device, "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": device, "stream": stream}}


def _cpu(name, ts, dur, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 100, "tid": tid, "ts": ts, "dur": dur, "args": {}}


def test_capture_and_summarize_trace(tmp_path):
    f = lambda x: torch.tanh(x @ x).sum()
    x = torch.from_numpy(np.random.RandomState(0).randn(256, 256).astype(np.float32))
    f(x)
    out = str(tmp_path / "trace")
    steps = 3
    with capture_trace(out):
        for _ in range(steps):
            f(x)
    s = summarize_trace(out, steps=steps)
    assert s.plane == CPU_PLANE and s.steps == steps
    assert s.total_ms > 0
    assert s.families and all(fam.total_ms >= 0 for fam in s.families)
    by_name = {fam.name: fam for fam in s.families}
    assert by_name["tanh"].count == 1 and by_name["mm"].count == 1
    assert abs(sum(fam.total_ms for fam in s.families) - s.total_ms) <= 1e-9 * max(1.0, s.total_ms)
    txt = format_table(s, top=5)
    assert "ms/step" in txt and s.plane in txt and "CPU operator self time" in txt


@pytest.mark.parametrize("mode", ["infer", "train", "export"])
def test_profile_step_cli(tmp_path, capsys, mode):
    """profile_step end to end on a tiny model on the CPU, with its JSON
    (export: a request of the serving export's reloaded artifact)."""
    argv = ["--model", "yolov10n", "--weights", "none", "--mode", mode, "--imgsz", "64", "--batch-size", "2",
            "--dtype", "float32", "--steps", "2", "--max-boxes", "4", "--device", "cpu",
            "--out-dir", str(tmp_path / "prof"), "--json", str(tmp_path / "p.json")]
    profile_step.main(argv)
    out = capsys.readouterr().out
    assert "CPU operator self time" in out and "plane: cpu" in out
    data = json.load(open(tmp_path / "p.json"))
    assert set(data) == {"plane", "total_ms_per_step", "steps", "wall_ms_median", "event_ms_median", "peak_gib",
                         "families"}
    assert data["plane"] == "cpu" and data["steps"] == 2 and data["total_ms_per_step"] > 0 and data["families"]
    assert data["wall_ms_median"] > 0
    assert data["event_ms_median"] is None and data["peak_gib"] is None  # CUDA events and peak memory are the card's
    assert "ms/step (host clock, median of the 2 profiled steps)" in out
    assert all(set(f) == {"name", "ms_per_step", "count", "example"} for f in data["families"])
    names = {f["name"] for f in data["families"]}
    assert ("convolution_backward" in names) == (mode == "train")


@pytest.mark.parametrize("name,family", sorted(REAL_NAMES.items()))
def test_family_of_real_kernel_names(name, family):
    assert _family(name) == family


def test_port_kernels_are_families_of_their_own():
    """Each of the port's eight kernels is a family, and no library kernel
    falls into one (the port's kernels live in a top-level anonymous
    namespace or `sm90::`; PyTorch's, cuDNN's and cuBLAS's do not)."""
    fams = {}
    for name in REAL_NAMES:
        fams.setdefault(_family(name), []).append(name)
    assert set(PORT_KERNELS) <= set(fams)
    ours = ("void (anonymous namespace)::", "(anonymous namespace)::", "void sm90::")
    for fam in PORT_KERNELS:
        assert all(n.startswith(ours) for n in fams[fam]), fams[fam]


def test_summarize_kernel_events(tmp_path):
    """The card's plane: kernels' own durations (host events aside), overlap
    on two streams counted once in the total, families by base identifier."""
    evs = []
    for step in range(2):
        t = 1000.0 * step
        evs += [_cpu("aten::conv2d", t, 500.0), _cpu("cudaLaunchKernel", t + 1, 5.0, cat="cuda_runtime"),
                _kernel("void (anonymous namespace)::stem_tc_kernel<32, 64, unsigned char>(unsigned char const*, "
                        "uint4 const*, __nv_bfloat16 const*, uint4 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
                        "int, int, int)", t + 10, 100.0),
                _kernel("void sm90::gemm_kernel<64, 1>(CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16 const*, "
                        "int, int, int)", t + 200, 40.0),
                _kernel("void sm90::gemm_kernel<128, 2>(CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16 "
                        "const*, int, int, int)", t + 220, 60.0, stream=9),  # overlaps the first by 20 us
                {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0, "tid": 7, "ts": t + 400,
                 "dur": 30.0, "args": {"device": 0}}]
    d = tmp_path / "t"
    d.mkdir()
    _write_trace(d / "a.pt.trace.json", evs)
    s = summarize_trace(str(d), steps=2)
    assert s.plane == "cuda:0 (NVIDIA H100 80GB HBM3)"
    fams = {f.name: f for f in s.families}
    assert set(fams) == {"stem_tc_kernel", "gemm_kernel"}
    assert (fams["stem_tc_kernel"].count, fams["gemm_kernel"].count) == (1, 2)
    assert fams["stem_tc_kernel"].total_ms == pytest.approx(0.1)
    assert fams["gemm_kernel"].total_ms == pytest.approx(0.1)
    assert fams["gemm_kernel"].example.startswith("void sm90::gemm_kernel<128, 2>")
    assert s.total_ms == pytest.approx(0.18)  # 100 + the 80 us the two GEMMs span
    assert [f.name for f in s.families][0] in ("stem_tc_kernel", "gemm_kernel")
    assert summarize_trace(str(d), steps=2, plane_filter="cuda:0").plane == s.plane
    with pytest.raises(ValueError, match="no plane matches"):
        summarize_trace(str(d), plane_filter="cuda:3")
    txt = format_table(s, top=1)
    assert "on-device kernel time: 0.180 ms/step" in txt and "... 1 more families" in txt


def test_summarize_picks_the_newest_trace_and_each_device(tmp_path):
    d = tmp_path / "t"
    d.mkdir()
    devices = ({"id": 0, "name": "A"}, {"id": 1, "name": "B"})
    _write_trace(d / "old.pt.trace.json", [_kernel("k_old", 0, 5.0)], devices)
    import os
    import time

    os.utime(d / "old.pt.trace.json", (time.time() - 60, time.time() - 60))
    _write_trace(d / "new.pt.trace.json", [_kernel("void k<1>(int)", 0, 5.0), _kernel("j", 0, 7.0, device=1)],
                 devices)
    assert summarize_trace(str(d)).families[0].name == "k"
    s1 = summarize_trace(str(d), plane_filter="cuda:1")
    assert s1.plane == "cuda:1 (B)" and s1.total_ms == pytest.approx(0.007)


@pytest.mark.parametrize("case", ["cuda_no_kernels", "cpu_no_ops", "device_listed_no_kernels"])
def test_no_kernel_events_raises(tmp_path, case):
    """A trace whose plane holds no event raises: never a 0 ms step."""
    d = tmp_path / "t"
    d.mkdir()
    if case == "cuda_no_kernels":  # the runtime launched, the kernel records went missing
        _write_trace(d / "a.pt.trace.json", [_cpu("aten::add", 0, 10.0),
                                             _cpu("cudaLaunchKernel", 1, 5.0, cat="cuda_runtime")], devices=())
    elif case == "cpu_no_ops":
        _write_trace(d / "a.pt.trace.json", [_cpu("py", 0, 10.0, cat="python_function")], devices=())
    else:
        _write_trace(d / "a.pt.trace.json", [_cpu("aten::add", 0, 10.0)])
    with pytest.raises(RuntimeError, match="holds no kernel events"):
        summarize_trace(str(d))
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path / "nothing"))


def test_cpu_self_times_do_not_count_nesting_twice(tmp_path):
    d = tmp_path / "t"
    d.mkdir()
    _write_trace(d / "a.pt.trace.json", [
        _cpu("aten::conv2d", 0, 100.0), _cpu("aten::convolution", 10, 30.0), _cpu("aten::_convolution", 12, 20.0),
        _cpu("aten::add", 50, 10.0), _cpu("aten::add", 200, 5.0, tid=2)], devices=())
    s = summarize_trace(str(d))
    fams = {f.name: f.total_ms for f in s.families}
    assert fams == pytest.approx({"conv2d": 0.06, "convolution": 0.01, "_convolution": 0.02, "add": 0.015})
    assert s.total_ms == pytest.approx(0.105)


def test_parser_matches_jax(monkeypatch):
    """Same flags, defaults and choices as JAX's profile_step, plus --device
    (default: the card); --out-dir defaults into the working directory."""
    monkeypatch.setattr(sys, "argv", ["profile_step.py"])
    want = vars(jprofile_step.parse_args())
    got = vars(profile_step.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got.pop("out_dir") == "runs/profile" and want.pop("out_dir")
    assert got == want
    argv = ["--model", "yolov10n", "--weights", "w.npz", "--mode", "train", "--imgsz", "320", "--batch-size", "8",
            "--dtype", "float32", "--decode", "nms", "--fuse", "--steps", "4", "--max-boxes", "7", "--out-dir", "o",
            "--top", "9", "--json", "j.json"]
    monkeypatch.setattr(sys, "argv", ["profile_step.py"] + argv)
    want = vars(jprofile_step.parse_args())
    got = vars(profile_step.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu" and got == want
    for bad in (["--mode", "serve"], ["--dtype", "fp16"], ["--decode", "approx"]):
        monkeypatch.setattr(sys, "argv", ["profile_step.py"] + bad)
        with pytest.raises(SystemExit):
            jprofile_step.parse_args()
        with pytest.raises(SystemExit):
            profile_step.parse_args(bad)


def test_chip_smoke_device_ms_counts_the_records_kept(monkeypatch):
    """chip_smoke.py's device time a call from profiles that lost records:
    each kernel's mean record time times its records a call, never the sum
    over `reps` (3 of 10 stem records kept give 0.2706 ms, not 0.0812); a
    call of several kernels takes the most records any profile kept of
    each, rounded up to a whole number a call, and a profile that lost some
    is taken again (four at most) unless it holds one kernel."""
    import chip_smoke as cs

    stem = [("stem_tc_kernel", 3, 811.8)]
    assert cs.records_ms([stem], 10) == pytest.approx(0.2706)
    whole = [("a", 10, 500.0), ("b", 20, 300.0)]
    assert cs.records_ms([whole], 10) == pytest.approx(0.08)
    lossy = [("a", 9, 450.0), ("b", 12, 180.0)]  # 1 and 8 records lost
    assert cs.records_ms([lossy], 10) == pytest.approx(0.08)
    assert cs.records_ms([lossy, [("a", 4, 200.0), ("b", 20, 300.0)]], 10) == pytest.approx(0.08)
    assert cs.records_ms([[]], 10) is None

    calls, profiles = [], []

    def fake_profiled(fn):  # each profile keeps what the next entry says
        fn()
        cs.LAST_EVENTS[:] = profiles.pop(0)
        return None, sum(t for _, _, t in cs.LAST_EVENTS) / 1e3

    monkeypatch.setattr(cs, "profiled", fake_profiled)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    fn = lambda: calls.append(1)  # noqa: E731
    profiles[:] = [stem, stem]
    assert cs.device_ms(fn) == pytest.approx(0.2706) and len(profiles) == 1  # one kernel: no retry
    profiles[:] = [lossy, whole, lossy]
    assert cs.device_ms(fn) == pytest.approx(0.08) and len(profiles) == 1
    profiles[:] = [lossy] * 5
    assert cs.device_ms(fn) == pytest.approx(0.08) and len(profiles) == 1
    profiles[:] = [[]] * 4
    with pytest.raises(SystemExit):
        cs.device_ms(fn)
