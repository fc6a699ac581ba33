"""The port's profiling helpers (``utils/profiling.py``) on the CPU: the
JAX package's ``test_profiler_trace_smoke`` (tests/test_cli_misc.py) with
torch work in the traced block."""

import json
import os

import torch

from audio_sheet_retrieval_tpu_torch.utils import profiling

import torch_port_helpers  # noqa: F401  (one torch thread a test process)


def test_profiler_trace_smoke(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as path:
        for _ in range(4):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    assert path == str(tmp_path / "trace" / "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    assert any("mm" in ev.get("name", "") for ev in events)
    # no card here: no statistics, and no fallback onto the host's
    assert profiling.device_memory_stats() == {}

