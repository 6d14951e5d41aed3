"""Fixtures of the benchmark's own tests: small copies of the cells for the
CPU, and the card test's fixture."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """Skips the test unless the process sees a CUDA card (decided here,
    when the test runs, and never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")


def small_cell(name: str, degree: int = 64, nmoduli: int = 2, batch: int = 4,
               terms: int = 3):
    """(manifest, cell name, cfg, mix) of a cell `<config>.<traffic>` cut
    to `degree` and `nmoduli` primes, with `batch` polynomials an operand,
    for the CPU.  The configuration and the mix are read from their files,
    so a mix that no cell of BENCHMARK.json runs yet is tested too."""
    import json
    from portbench import run
    manifest = run.load_manifest()
    config, traffic = name.split(".")
    cfg = json.loads((run.HERE / "configs" / f"{config}.json").read_text())
    mix = json.loads((run.HERE / "mixes" / f"{traffic}.json").read_text())
    cfg = dict(cfg, degree=degree, nmoduli=nmoduli,
               modulus_bits=nmoduli * cfg["prime_bits"],
               primes=cfg["primes"][:nmoduli],
               primitive_roots=cfg["primitive_roots"][:nmoduli])
    item = 4 if cfg["limb"] == "u32" else 8
    mix = dict(mix, operand_mib=batch * nmoduli * degree * item / 2 ** 20)
    if mix["kind"] == "macc":
        mix["terms"] = terms
    return manifest, name, cfg, mix

