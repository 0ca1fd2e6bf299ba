import os

# Tests run on the single real CPU device — only the dry-run forces 512
# placeholder devices, and it does so in its own process.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# jax 0.4.x's CPU thunk runtime intermittently segfaults inside
# backend_compile after hundreds of in-process compilations (observed at
# ~85% of this suite at *varying* tests, always the same
# compiler.py:backend_compile stack, single-core rigs). The legacy CPU
# runtime is stable under the same load, so pin it for the test process on
# the affected series; newer jaxlib removed the legacy runtime (and the
# flag) along with the instability, so gate on version.
if "xla_cpu_use_thunk_runtime" not in os.environ.get("XLA_FLAGS", ""):
    import jaxlib

    if tuple(int(x) for x in jaxlib.__version__.split(".")[:2]) < (0, 5):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_cpu_use_thunk_runtime=false"
        ).strip()

try:
    import hypothesis
except ImportError:  # optional dev dependency — property tests skip without it
    hypothesis = None

if hypothesis is not None:
    hypothesis.settings.register_profile(
        "repro",
        max_examples=25,
        deadline=None,
        derandomize=True,
        suppress_health_check=list(hypothesis.HealthCheck),
    )
    hypothesis.settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (repro_torch's CUDA kernels); skips without one"
    )
