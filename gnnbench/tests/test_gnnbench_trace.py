"""The kernel groups on recorded device-operation names, busy and idle
time, and the breakdown."""

import pytest

import gnnbench_cells  # noqa: F401
from gnnbench import trace

# names as torch.profiler reports them on the card (kernels of the port,
# of PyTorch, of cuBLAS, copies)
RECORDED = {
    "void bin_gat_fwd_kernel<4, true, 8>(BinGatArgs<__nv_bfloat16>)": "own",
    "void dense_gat_bwd_kernel<4, 8>(DenseGatBwdArgs)": "own",
    "void dense_gmm_fwd_kernel<4, 2, 8>(DenseGmmFwdArgs)": "own",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
    "at::native::FillFunctor<float>, std::array<char*, 1ul>)": "torch",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
    "FusedAdamMathFunctor>(...)": "torch",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()(at::TensorIterator&)::{lambda(float, "
    "float)#1}>, unsigned int, float, 4> >(...)": "torch",
    "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32_warpgroupsize"
    "1x1x1_execute_segment_k_off_kernel__5x_cublas": "gemm",
    "ampere_sgemm_128x64_tn": "gemm",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nt_align1>("
    "cutlass_80_simt_sgemm_128x64_8x5_nt_align1::Params)": "gemm",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, "
    "float, false, false, false>(...)": "gemm",
    "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, "
    "4, 4, false, false, cublasGemvParamsEx<int, cublasGemvTensorStrided"
    "Batched<float const>, cublasGemvTensorStridedBatched<float const>, "
    "cublasGemvTensorStridedBatched<float>, float> >(...)": "gemm",
    "void (anonymous namespace)::softmax_warp_forward<float, float, float, 6,"
    " true, false>(float*, float const*, int, int, int, bool const*, int, "
    "bool)": "torch",
    "void (anonymous namespace)::softmax_warp_backward<float, float, float, "
    "6, true, false>(float*, float const*, float const*, int, int, int, bool "
    "const*)": "torch",
    "void (anonymous namespace)::bin_gat_bwd_kernel<__nv_bfloat16, 4, true, "
    "8>(__nv_bfloat16 const*, float const*, dgnn::BinList)": "own",
    "void (anonymous namespace)::dense_gat_fwd_kernel<4, 2>(float const*, "
    "int const*, unsigned int const*)": "own",
    "Memcpy DtoD (Device -> Device)": "copy",
    "Memset (Device)": "copy",
}


@pytest.mark.parametrize("name,want", sorted(RECORDED.items()))
def test_group(name, want):
    assert trace.group(name) == want


def _trace():
    ops = [("void bin_gat_fwd_kernel<4, true, 8>(x)", 0.0, 10.0),
           ("void at::native::fill(x)", 5.0, 12.0),
           ("ampere_sgemm_128x64_tn", 20.0, 30.0),
           ("Memset (Device)", 40.0, 41.0)]
    host = [("cudaGraphLaunch", 0.0, 50.0),
            ("cudaEventSynchronize", 11.0, 35.0)]
    return trace.Trace(ops, host, steps=2)


def test_busy_idle_and_groups():
    t = _trace()
    assert t.busy == [[0.0, 12.0], [20.0, 30.0], [40.0, 41.0]]
    assert t.busy_s == pytest.approx(23e-6)
    assert t.window_s == pytest.approx(41e-6)
    assert t.seconds(trace.OWN) == pytest.approx(10e-6)
    assert t.seconds(trace.GLUE) == pytest.approx(8e-6)
    assert t.launches() == 3


def test_breakdown():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["void bin_gat_fwd_kernel<4, true, 8>(x)",
                                  pytest.approx(10e-6)]
    assert b["idle_gaps"] == [["cudaEventSynchronize", pytest.approx(10e-6)],
                              ["cudaEventSynchronize", pytest.approx(8e-6)]]


def test_an_empty_trace_is_an_error():
    with pytest.raises(RuntimeError):
        trace.Trace([], [], 1)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    gnnbench_cells.SPEC["per_layer"]])
def test_every_reader_reads_a_trace(metric):
    """Each per-layer reader gives a finite number from a trace, the run's
    end-to-end values and the counts (or None where it finds nothing);
    a share of a roofline or a peak stays within 0 and 100."""
    import math
    import types

    from gnnbench.harness import load_module
    from gnnbench.peaks import PEAKS

    reader = load_module(gnnbench_cells.FOLDER / "metrics" / f"{metric}.py",
                         f"gnnbench_metric_{metric}")
    ctx = types.SimpleNamespace(
        trace=_trace(), peaks=PEAKS["NVIDIA H100 80GB HBM3"],
        e2e={"train_ms": 250.0, "train_ms.citation": 1.7,
             "infer_ms.p95": 86.0},
        least_mp_s=2e-6, model_flops=1e9)
    v = reader.read(ctx)
    assert v is not None and math.isfinite(v)
    if "roofline" in metric or "mfu" in metric or "pct" in metric:
        assert 0 <= v <= 100, v
