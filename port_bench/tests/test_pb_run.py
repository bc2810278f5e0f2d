"""The command's refusals: no result without CUDA, and none from a
checkout that holds only the benchmark; and its process's one thread in
each numerical library's pool."""

import shutil
import subprocess
import sys

import pytest

from port_bench import harness

ARGS = ["-m", "port_bench.run", "--workload", "train.resnet50.b32t100",
        "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"]


def test_no_result_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable] + ARGS, cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from port_bench.run import run_cell; "
            "run_cell('train.resnet50.b32t100', 1, 0.1, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "pvr_habitat_tpu_torch" in out.stderr


def test_one_thread_in_each_pool():
    code = ("import os, runpy, sys\n"
            "sys.argv = ['run', '--help']\n"
            "try:\n"
            "    runpy.run_module('port_bench.run', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "import torch\n"
            "print(os.environ['OMP_NUM_THREADS'], torch.get_num_threads())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["1", "1"]
