"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX package's)."""
import os
import subprocess
import sys

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_top_level_names_compared_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "umbrella_tpu_torch.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "umbrella_tpu.probe", sys)
    assert "umbrella_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """Import every module a run imports, and the port's modules it drives, in
    a fresh process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness, benchmark.trace, benchmark.reference\n"
            "import benchmark.configs.mistral7b_awq, benchmark.configs.mixtral8x7b\n"
            "import benchmark.configs.mixtral8x7b_ep4\n"
            "import umbrella_tpu_torch.serving.scheduler, umbrella_tpu_torch.serving.batched_engine\n"
            "import umbrella_tpu_torch.speculation.auto_engine, umbrella_tpu_torch.models.moe\n"
            "import umbrella_tpu_torch.quantization.loader, umbrella_tpu_torch.quantization.int4f\n"
            "from benchmark import spec\n"
            "for m in spec.benchmark()['end_to_end'] + spec.benchmark()['per_layer']:\n"
            "    spec.reader(m['name'])\n"
            "print(benchmark.harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    src = open(os.path.join(ROOT, "benchmark", "reference.py")).read()
    assert "umbrella_tpu" not in src.replace("umbrella_tpu_torch", "")
    assert "import umbrella_tpu_torch" not in src and "from umbrella_tpu_torch" not in src


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "mistral7b_awq.serve32", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
