"""The SSD scan kernel's three passes, as far as the CPU can check them:
the wrapper's ctypes signatures and scratch size against the C source,
and ``chip_smoke.py``'s per-pass readings (device time from a profiler
trace, the ptxas report).  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``)."""

import re
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402

SOURCE = (build.KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_chunked.cu").read_text()


@pytest.mark.parametrize("name", ["ssd_chunked", "ssd_chunked_smem_bytes"])
def test_signatures_match_the_c_source(name):
    """As many ctypes argtypes as the C declaration has parameters: a wrong
    count would pass garbage on the card."""
    decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", SOURCE).group(1)
    assert len(ops.SIGNATURES[name]) == decl.count(",") + 1


def test_every_pass_is_a_kernel_of_the_source():
    """``PASSES`` names the source's kernels, in the order ``launch`` runs
    them, and ``ssd_chunked_smem_bytes`` takes them by that index."""
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\) ssd_chunked_(\w+)_kernel",
                         SOURCE)
    assert tuple(kernels) == ops.PASSES == ("chunk", "state", "output")
    launches = re.findall(r"ssd_chunked_(\w+)_kernel<T><<<|launch_overlapped\(ssd_chunked_(\w+)_kernel",
                          SOURCE)
    assert tuple("".join(names) for names in launches) == ops.PASSES
    smem = SOURCE[SOURCE.index('extern "C" int ssd_chunked_smem_bytes'):]
    for i, layout in enumerate(("ChunkSmem", "0", "OutSmem")):
        assert re.search(rf"case {i}: return [^;]*{layout}", smem)


@pytest.mark.parametrize("b,t,h,p,n,chunk", [(1, 2048, 32, 64, 128, 64),
                                             (4, 256, 3, 48, 80, 64),
                                             (2, 0, 2, 16, 16, 16)])
def test_workspace_floats_holds_the_three_scratch_arrays(b, t, h, p, n, chunk):
    """The state entering each chunk [B, H, nc, N, P], C B^T [B, nc, Q, Q]
    and each chunk's total decay [B, H, nc], as the C source lays them out
    and checks them (``workspace_floats``): at mamba2-370m FULL, B = 1,
    T = 2048 the states take 33,554,432 bytes."""
    nc = t // chunk
    assert ops.workspace_floats(b, t, h, p, n, chunk) == (
        b * h * nc * n * p + b * nc * chunk * chunk + b * h * nc)
    assert re.search(r"batch \* nc \* \(\(size_t\)H \* N \* P \+ \(size_t\)Q \* Q \+ H\)",
                     SOURCE)
    if (b, t) == (1, 2048):
        assert 4 * b * h * nc * n * p == 33_554_432


def test_device_times_sums_every_pass_of_a_kernel():
    """A kernel's device time in a profiled run sums each of its passes
    (each template instantiation too), keeps each pass apart, and counts
    calls by wrapper launches; B2's split and combine passes keep their
    names; host entries are not device time."""
    from torch.autograd import DeviceType

    import chip_smoke as cs

    def evt(key, us, device=DeviceType.CUDA):
        return SimpleNamespace(key=key, device_time_total=us, count=1, device_type=device)

    ns = "void (anonymous namespace)::"
    events = [
        evt(ns + "ssd_chunked_chunk_kernel<__nv_bfloat16>((anonymous namespace)::Args)", 300.0),
        evt(ns + "ssd_chunked_chunk_kernel<float>((anonymous namespace)::Args)", 100.0),
        evt(ns + "ssd_chunked_state_kernel((anonymous namespace)::Args)", 50.0),
        evt(ns + "ssd_chunked_output_kernel<__nv_bfloat16>((anonymous namespace)::Args)", 500.0),
        evt(ns + "paged_decode_attention_kernel<bf16, 64>(Args)", 40.0),
        evt(ns + "paged_decode_attention_combine_kernel(Args)", 10.0),
        evt(ns + "decode_attention_kernel<bf16, 64>(Args)", 20.0),
        evt("ssd_chunked", 9000.0, DeviceType.CPU),
        evt("void at::native::elementwise_kernel<128, 4>", 25.0),
    ]
    prof = SimpleNamespace(key_averages=lambda: events)
    out = cs.device_times(prof, 1.0, {"ssd_chunked": 4, "paged_decode_attention": 2})
    ssd = out["kernels"]["ssd_chunked"]
    assert ssd["calls"] == 4
    assert ssd["device_ms"] == pytest.approx(0.95)
    assert ssd["device_ms_by_pass"] == pytest.approx(
        {"chunk_kernel": 0.4, "state_kernel": 0.05, "output_kernel": 0.5})
    assert out["kernels"]["paged_decode_attention"]["device_ms_by_pass"] == pytest.approx(
        {"kernel": 0.04, "combine_kernel": 0.01})
    assert out["kernels"]["decode_attention"]["device_ms_by_pass"] == pytest.approx(
        {"kernel": 0.02})
    assert out["device_s"] == pytest.approx(1045e-6)


def test_ptxas_report_by_pass():
    """nvcc's -Xptxas -v lines of each pass and instantiation, by the
    kernel's mangled name."""
    import chip_smoke as cs
    fn = "_ZN46_GLOBAL__N__0a1b2c3d_14_ssd_chunked_cu_5f6a7b8c24ssd_chunked_{}"
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{fn.format('output_kernelIfEEvNS_4ArgsE')}' "
        "for 'sm_90a'",
        f"ptxas info    : Function properties for {fn.format('output_kernelIfEEvNS_4ArgsE')}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 440 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        f"'{fn.format('chunk_kernelI13__nv_bfloat16EEvNS_4ArgsE')}' for 'sm_90a'",
        "ptxas info    : Used 64 registers, used 1 barriers, 440 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{fn.format('state_kernelENS_4ArgsE')}' "
        "for 'sm_90a'",
        "ptxas info    : Used 40 registers, 440 bytes cmem[0]",
    ])
    by_pass = cs.ssd_ptxas_by_pass(report)
    assert set(by_pass) == {"output/f32", "chunk/bf16", "state"}
    assert by_pass["output/f32"] == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 440 bytes cmem[0]"]
    assert by_pass["state"] == ["ptxas info    : Used 40 registers, 440 bytes cmem[0]"]
