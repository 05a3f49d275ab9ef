"""The port's host utilities (`htd_tpu_torch/utils/`, after
`htd_tpu/utils/logger.py` and `profiling.py`) on the CPU, in one
process: the logger's file, the environment snapshot, the timer and the
Chrome trace."""

import json
import logging

import torch

from htd_tpu_torch.utils import collect_env, get_root_logger, profile_time, trace_to


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
