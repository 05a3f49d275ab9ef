"""The port's host utilities (`htd_tpu_torch/utils/`, after
`htd_tpu/utils/logger.py` and `profiling.py`) on the CPU, in one
process: the logger's file, the environment snapshot, the timer, the
Chrome trace, and the kernel counts read from a trace (the profiler stood
in for)."""

import json
import logging
import re
from pathlib import Path

import pytest
import torch

from htd_tpu_torch.utils import collect_env, get_root_logger, profile_time, trace_to
from htd_tpu_torch.utils import profiling


def test_root_logger_writes_its_file_and_switches_files(tmp_path, capsys):
    """Without a process group the process is rank 0: each line goes to
    stdout and to the file, a call with another file moves the file
    handler there, and a call without one keeps it."""
    first, second = tmp_path / "a.log", tmp_path / "b.log"
    logger = get_root_logger(str(first))
    logger.info("one")
    assert get_root_logger(str(second)) is logger
    logger.info("two")
    get_root_logger().info("three")
    assert [line.split(" - ")[-1] for line in first.read_text().splitlines()] == ["one"]
    assert [line.split(" - ")[-1] for line in second.read_text().splitlines()] == ["two", "three"]
    assert [line.split(" - ")[-1] for line in capsys.readouterr().out.splitlines()] == \
        ["one", "two", "three"]
    assert logger.level == logging.INFO
    assert sum(isinstance(h, logging.FileHandler) for h in logger.handlers) == 1


def test_collect_env_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = collect_env()
    assert info["torch"] == torch.__version__ and info["world_size"] == 1
    assert info["device_count"] == 0 and "gpu" not in info
    assert json.loads(json.dumps(info)) == info


def test_profile_time_prints_the_region(capsys):
    with profile_time("region"):
        torch.ones(4).sum()
    out = capsys.readouterr().out.strip()
    assert out.startswith("region elapsed: ") and out.endswith(" ms")
    assert float(out.split()[-2]) >= 0


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])


# device records as the profiler names them, demangled
_NS = "void (anonymous namespace)::"


@pytest.mark.parametrize("names, want", [
    ([_NS + "deform_conv_fwd_tc_kernel<128>(__nv_bfloat16 const*, __nv_bfloat16 const*)",
      _NS + "deform_conv_fwd_tc_kernel<64>(__nv_bfloat16 const*, __nv_bfloat16 const*)",
      _NS + "deform_conv_fwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*, DcnParams)",
      _NS + "deform_conv_fwd_kernel<float>(float const*, DcnParams)",
      _NS + "deform_conv_fwd_grouped_tc_kernel<16>(__nv_bfloat16 const*, DcnParams)"],
     {"deform_conv_fwd_tc_kernel": 2, "deform_conv_fwd_kernel": 2,
      "deform_conv_fwd_grouped_tc_kernel": 1}),
    ([_NS + "deform_conv_bwd_input_tc_kernel(__nv_bfloat16 const*, float*, DcnParams)",
      _NS + "deform_conv_bwd_input_kernel<float>(float const*, float*, DcnParams)"],
     {"deform_conv_bwd_input_tc_kernel": 1, "deform_conv_bwd_input_kernel": 1}),
    ([_NS + "deform_conv_bwd_offset_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
      _NS + "deform_conv_bwd_weight_tc_kernel<256>(__nv_bfloat16 const*, float*)",
      _NS + "deform_conv_bwd_offset_kernel<float>(float const*)",
      _NS + "deform_conv_bwd_weight_kernel<float>(float const*, float*)"],
     {"deform_conv_bwd_offset_kernel": 2, "deform_conv_bwd_weight_tc_kernel": 1,
      "deform_conv_bwd_weight_kernel": 1}),
    ([_NS + "roi_align_fwd_kernel<__nv_bfloat16, 2>(__nv_bfloat16 const*, float const*)",
      _NS + "roi_align_fwd_kernel<float, 1>(float const*, float const*)",
      _NS + "roi_align_bwd_kernel<float>(float const*, float const*)",
      "pyramid_pack_kernel(uint4*, PackParams)"],
     {"roi_align_fwd_kernel": 2, "roi_align_bwd_kernel": 1, "pyramid_pack_kernel": 1}),
    (["void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >()",
      "Memcpy HtoD (Pageable -> Device)", "sm90_xmma_gemm_bf16bf16_bf16f32",
      _NS + "roi_align_fwd_kernel_v2<float>(float const*)",
      "void my_soft_nms_kernel<true>(float const*)"], {}),
], ids=["k3_paths", "k5_paths", "k6_paths", "roi_align_fwd_bwd", "not_the_ports"])
def test_count_kernels_by_whole_name(names, want):
    """Each path of K3, K5 and K6 and each direction of RoIAlign counts
    under its own `__global__` name; a name that only contains one of them
    counts nothing."""
    assert profiling.count_kernels(names) == want


def test_kernels_are_the_global_functions_of_csrc():
    """`KERNELS` holds every `__global__` function of `htd_tpu_torch/csrc`'s
    CUDA sources and nothing else, so that no kernel is missing from the
    counts read off a trace."""
    torch.set_num_threads(1)
    csrc = Path(profiling.__file__).resolve().parent.parent / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    found = {name for src in csrc.glob("*.cu*") for name in pattern.findall(src.read_text())}
    assert len(found) == 16
    assert found == profiling.KERNELS


class _Event:
    def __init__(self, name, device_type):
        self.name, self.device_type = name, device_type


class _Profile:
    """Stands in for `torch.profiler.profile`: trace i holds `held[i]` K2
    records (CUDA) and one host record that names K2."""

    held = []

    def __init__(self, activities):
        self.n = _Profile.held.pop(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        return [_Event(_NS + "roi_align_fwd_kernel<float, 1>(float const*)", cuda)] * self.n \
            + [_Event("roi_align_fwd_kernel", cpu), _Event("Memcpy DtoH", cuda)]


@pytest.mark.parametrize("held, runs", [([3], 1), ([2, 3], 2), ([1, 2, 3], 3), ([4], 1),
                                        ([2, 2, 2], None)],
                         ids=["whole", "short_once", "short_twice", "more", "short_thrice"])
def test_kernel_counts_traces_again_while_short(monkeypatch, held, runs):
    """`kernel_counts(fn, {K2: 3})` runs fn() under a new trace while the
    trace holds fewer than 3 K2 records, and raises after 3 such traces; a
    trace that holds as many or more is returned as it is; host records
    count nothing."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch, "ones", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(_Profile, "held", list(held))
    calls = []

    def fn():
        calls.append(1)
        return len(calls)

    if runs is None:
        with pytest.raises(RuntimeError, match="3 traces"):
            profiling.kernel_counts(fn, {"roi_align_fwd_kernel": 3})
        assert len(calls) == 3
    else:
        out, got = profiling.kernel_counts(fn, {"roi_align_fwd_kernel": 3})
        assert out == runs == len(calls) and got == {"roi_align_fwd_kernel": held[-1]}


def test_kernel_counts_rejects_what_is_not_a_kernel():
    with pytest.raises(ValueError, match="roi_align"):
        profiling.kernel_counts(lambda: None, {"roi_align": 3})
