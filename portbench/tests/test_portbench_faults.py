"""The comparison that decides `correct`, on the CPU at a small size: a
sound run is correct; the control (the reference in the program's place,
its products in float64) and each fault a cell can have, planted in the
port's timed path, are not."""
import pytest

import nfllib_tpu_torch as port
from nfllib_tpu_torch.apps import lwe
from nfllib_tpu_torch.prng import device_sampling
from portbench import control, run, traffic

from .conftest import small_cell

PRODUCTS = ("he128_u32_n16384_q420.products", "he128_u64_n32768_q868.products")
MACC = "he128_u64_n32768_q868.macc"
LWE = "he128_u32_n16384_q420.lwe"
SEED = 2 ** 31 + 99


def drive(name, **kw):
    manifest, name, cfg, mix = small_cell(name, **kw)
    return run.run_cell(manifest, name, cfg, mix, SEED, 0.2, False, "cpu")


def altered(x):
    """x with one residue moved by one (still below its prime)."""
    y = x.contiguous().clone()
    flat = y.view(-1)
    flat[7] = flat[7] + 1 if int(flat[7]) == 0 else flat[7] - 1
    return y


def half_left_out(x):
    y = x.clone()
    y[x.shape[0] // 2:] = 0
    return y


@pytest.mark.parametrize("name", PRODUCTS + (MACC, LWE))
def test_a_sound_run_is_correct(name):
    res = drive(name, batch=8 if name == LWE else 4)
    assert res["correct"] and res["failed"] == 0
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("name", PRODUCTS + (MACC, LWE))
def test_the_control_is_found_wrong(name):
    manifest, name, cfg, mix = small_cell(name, batch=8 if name == LWE else 4)
    kind = traffic.load_kind(mix["kind"])(port, cfg, mix, SEED, "cpu")
    checks = control.control_checks(kind, 2)
    assert any(checks[k] > mix["limits"][k] for k in checks)


@pytest.mark.parametrize("fault", [altered, half_left_out])
@pytest.mark.parametrize("name", PRODUCTS + (MACC,))
def test_an_answer_altered_or_half_the_batch_left_out(monkeypatch, name,
                                                      fault):
    inv = port.Poly.invntt_pow_invphi
    monkeypatch.setattr(port.Poly, "invntt_pow_invphi",
                        lambda self: port.Poly(fault(inv(self).data),
                                               self.ring))
    res = drive(name)
    assert not res["correct"] and res["checks"]["residues_wrong"]["value"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    poly = port.Expr.poly
    monkeypatch.setattr(port.Expr, "poly",
                        lambda self: self.args[0] if self.op == "add"
                        else poly(self))
    res = drive(MACC)
    assert not res["correct"]


@pytest.mark.parametrize("where", ["noise", "cipher", "bits"])
@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_lwe_faults(monkeypatch, where, fault):
    if where == "noise":
        f = device_sampling.device_gaussians
        monkeypatch.setattr(device_sampling, "device_gaussians",
                            lambda *a, **k: fault(f(*a, **k)))
    elif where == "cipher":
        f = lwe._encrypt_graph
        monkeypatch.setattr(lwe, "_encrypt_graph", lambda *a: tuple(
            fault(x) for x in f(*a)))
    else:
        f = lwe.decrypt
        monkeypatch.setattr(lwe, "decrypt",
                            lambda *a: 1 - f(*a) if fault is altered
                            else fault(1 - f(*a)))
    res = drive(LWE, batch=8)
    assert not res["correct"]
    assert res["checks"][f"{where}_wrong"]["value"] > 0
