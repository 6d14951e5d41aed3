"""The port's LWE demo (apps/lwe.py) against nfllib_tpu's: the encrypt and
decrypt graphs in every NFL_TORCH_NTT mode on tests/test_lwe_fused.py's
configs, keygen, the zero-sum gate, keys and ciphertexts carried across
both ways, and the mode reader's dispatch table.  Exact equality; the
port's tensors live on the CPU (DEV), where the chain kernels (K6/K8) and
the butterfly kernels run as their plain twins."""
import functools
import types

import jax
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.apps import lwe as jlwe
from nfllib_tpu.prng.salsa20 import Salsa20Stream as JStream
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import interop
from nfllib_tpu_torch.apps import lwe as tlwe
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.ops import (ntt_mxu, ntt_mxu_u64, ntt_pallas,
                                  ntt_pallas_u64)
from nfllib_tpu_torch.prng import Salsa20Stream

DEV = "cpu"
CONFIGS = [("u32", 512, 60), ("u32", 1024, 90), ("u16", 256, 14),
           ("u64", 512, 124)]
MODES = ["plain", "butterfly", "auto"]
KEY = b"\x05" * 32


@functools.lru_cache(maxsize=None)
def _jax_run(limb, degree, agg):
    """JAX keys, one encryption of zero from the same stream and its
    decryption, as numpy arrays."""
    ring = nfl.ring_from_modulus(limb, degree, agg)
    stream = JStream(KEY)
    g = jlwe.make_gaussian_prng()
    keys = jlwe.keygen(ring, stream, g)
    noise = [nfl.Poly.sample(ring, nfl.gaussian(g, amp), stream).data
             for amp in (1, 2, 2)]
    ra, rb = jlwe._encrypt_graph(ring.context(), keys.pka.data,
                                 keys.pkb.data, *noise)
    bits = jlwe._decrypt_graph(ring.context(), ra, rb, keys.s.data,
                               keys.sprime.data)
    arr = [np.asarray(a) for a in (keys.s.data, keys.sprime.data,
                                   keys.pka.data, keys.pkb.data)]
    return (arr, [np.asarray(v) for v in noise], np.asarray(ra),
            np.asarray(rb), np.asarray(bits))


def _tring(limb, degree, agg):
    return tnfl.ring_from_modulus(limb, degree, agg)


def _t(arr, ring):
    return interop.poly_from_numpy(arr, ring, DEV).data


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("limb,degree,agg", CONFIGS)
def test_graphs_match_jax(limb, degree, agg, mode, monkeypatch):
    monkeypatch.setenv("NFL_TORCH_NTT", mode)
    keys_np, noise, ra, rb, bits = _jax_run(limb, degree, agg)
    ring = _tring(limb, degree, agg)
    ctx = ring.context()
    keys = interop.lwe_keys_from_numpy(*keys_np, ring, device=DEV)
    want_mod = {"plain": None, "auto": None,
                "butterfly": ntt_pallas_u64 if limb == "u64" else ntt_pallas}
    assert tlwe._fused_chain_module(ring, keys.pka.data) is want_mod[mode]
    sa, sb = tlwe._encrypt_graph(ctx, keys.pka.data, keys.pkb.data,
                                 *(_t(v, ring) for v in noise))
    np.testing.assert_array_equal(sa.numpy().view(ring.dtype), ra)
    np.testing.assert_array_equal(sb.numpy().view(ring.dtype), rb)
    got = tlwe._decrypt_graph(ctx, sa, sb, keys.s.data, keys.sprime.data)
    assert got.dtype == ring.torch_dtype and got.shape == ring.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  bits.astype(np.int64))
    assert not bits.any()


@pytest.mark.parametrize("limb,degree,agg", CONFIGS)
def test_keygen_and_encrypt_match_jax(limb, degree, agg):
    """The port's keygen and encrypt draw the same stream as the JAX
    package's, so keys and ciphertexts are byte-identical."""
    keys_np, _, ra, rb, _ = _jax_run(limb, degree, agg)
    ring = _tring(limb, degree, agg)
    stream = Salsa20Stream(KEY)
    g = tlwe.make_gaussian_prng()
    keys = tlwe.keygen(ring, stream, g, device=DEV)
    for want, got in zip(keys_np, (keys.s, keys.sprime, keys.pka, keys.pkb)):
        np.testing.assert_array_equal(got.numpy(), want)
    resa, resb = tlwe.encrypt(keys, ring, stream, g)
    np.testing.assert_array_equal(resa.numpy(), ra)
    np.testing.assert_array_equal(resb.numpy(), rb)
    assert resa.device.type == "cpu"


@pytest.mark.parametrize("mode", ["plain", "butterfly"])
def test_zero_sum_check(mode, monkeypatch):
    monkeypatch.setenv("NFL_TORCH_NTT", mode)
    ring = _tring("u32", 512, 60)
    assert tlwe.run_zero_sum_check(ring, repetitions=3, key=b"\x0b" * 32,
                                   device=DEV)


@pytest.mark.parametrize("limb,degree,agg", [("u32", 512, 60),
                                             ("u64", 512, 124)])
def test_ciphertexts_cross_between_packages(limb, degree, agg):
    """Keys carried across by interop.lwe_keys_from_numpy: a JAX ciphertext
    decrypts to zero in the port, and a port ciphertext in the JAX
    package."""
    keys_np, _, ra, rb, _ = _jax_run(limb, degree, agg)
    ring = _tring(limb, degree, agg)
    keys = interop.lwe_keys_from_numpy(*keys_np, ring, device=DEV)
    bits = tlwe.decrypt(keys, ring, interop.poly_from_numpy(ra, ring, DEV),
                        interop.poly_from_numpy(rb, ring, DEV))
    assert not bool(bits.any())
    g = tlwe.make_gaussian_prng()
    ta, tb = tlwe.encrypt(keys, ring, Salsa20Stream(b"\x07" * 32), g)
    jring = nfl.ring_from_modulus(limb, degree, agg)
    jkeys = jlwe.LweKeys(*(nfl.Poly(a, jring) for a in keys_np))
    jbits = jlwe.decrypt(jkeys, jring, nfl.Poly(ta.numpy(), jring),
                         nfl.Poly(tb.numpy(), jring))
    assert not np.asarray(jbits).any()


def test_mode_reader_table(monkeypatch):
    """Which module each mode picks, per limb, device and degree: the fused
    four-step module (ntt_pow_phi; under auto on a CUDA tensor only where
    no butterfly module serves the ring), the butterfly module (ntt,
    inv_ntt; ntt_pow_phi when no fused module) and the LWE chain module.
    The rings cover the edges of the butterfly modules' degrees: u16 and
    u32 from 256, u64 from 256 to 2^16."""
    cuda = types.SimpleNamespace(is_cuda=True)
    cpu = torch.zeros(1)
    rings = {name: tnfl.ring_from_modulus(*cfg) for name, cfg in {
        "u32_16384": ("u32", 16384, 510), "u32_128": ("u32", 128, 60),
        "u32_256": ("u32", 256, 60), "u32_2^15": ("u32", 1 << 15, 60),
        "u16_256": ("u16", 256, 14), "u64_16384": ("u64", 16384, 496),
        "u64_128": ("u64", 128, 62), "u64_256": ("u64", 256, 62),
        "u64_2^15": ("u64", 1 << 15, 62), "u64_2^16": ("u64", 1 << 16, 62),
        "u64_2^17": ("u64", 1 << 17, 62)}.items()}
    bfly = {"u32_16384": ntt_pallas, "u32_128": None, "u32_256": ntt_pallas,
            "u32_2^15": ntt_pallas, "u16_256": ntt_pallas,
            "u64_16384": ntt_pallas_u64, "u64_128": None,
            "u64_256": ntt_pallas_u64, "u64_2^15": ntt_pallas_u64,
            "u64_2^16": ntt_pallas_u64, "u64_2^17": None}
    fused = {name: ntt_mxu_u64 if ring.limb == "u64" else ntt_mxu
             for name, ring in rings.items()}
    for mode in ("auto", "plain", "butterfly", "fused"):
        monkeypatch.setenv("NFL_TORCH_NTT", mode)
        assert tntt.kernel_mode() == mode
        for name, ring in rings.items():
            for dev, x in (("cuda", cuda), ("cpu", cpu)):
                want_fused = fused[name] if mode == "fused" or (
                    mode == "auto" and (dev == "cpu" or bfly[name] is None)) \
                    else None
                assert tntt._fused_module(ring, x) is want_fused, \
                    (mode, name, dev)
                want = bfly[name]
                if mode == "plain" or (mode == "auto" and dev == "cpu"):
                    want = None
                assert tntt._butterfly_module(ring, x) is want, \
                    (mode, name, dev)
                chain = want if mode == "butterfly" else None
                assert tlwe._fused_chain_module(ring, x) is chain, \
                    (mode, name, dev)
    monkeypatch.setenv("NFL_TORCH_NTT", "pallas")
    with pytest.raises(ValueError):
        tntt.kernel_mode()


def test_constructors_default_to_the_card():
    """With no device named, every constructor puts its tensor on the
    card; without one it raises instead of computing on the CPU."""
    ring = _tring("u32", 256, 60)
    calls = [
        lambda: tnfl.Poly.zeros(ring),
        lambda: tnfl.Poly.from_coeffs(ring, [1, 2]),
        lambda: tnfl.Poly.constant(ring, 3),
        lambda: tnfl.Poly.from_numpy(ring, np.zeros(ring.shape, np.uint32)),
        lambda: tnfl.Poly.sample(ring, tnfl.uniform(), Salsa20Stream(KEY)),
        lambda: tnfl.deserialize_poly(ring, bytes(4 * 512)),
        lambda: tnfl.mpz2poly(ring, [0] * 256),
        lambda: tnfl.set_mpz(ring, [1]),
        lambda: interop.poly_from_numpy(np.zeros(ring.shape, np.uint32),
                                        ring),
        lambda: tlwe.keygen(ring, Salsa20Stream(KEY),
                            tlwe.make_gaussian_prng()),
    ]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            out = out.s if isinstance(out, tlwe.LweKeys) else out
            assert out.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


# ---------------------------------------------------------------------------
# encrypt_on_device: the noise sampled on the keys' device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "butterfly"])
@pytest.mark.parametrize("limb,degree,agg", [("u32", 256, 60),
                                             ("u64", 256, 124)])
def test_encrypt_on_device_decrypts_to_zero(limb, degree, agg, mode,
                                            monkeypatch):
    """The fixed-consumption device Gaussian feeds the encrypt graph (K6/K8
    in butterfly mode): decryptions sum to exactly zero, with int and
    tensor nonces."""
    monkeypatch.setenv("NFL_TORCH_NTT", mode)
    ring = _tring(limb, degree, agg)
    g = tlwe.make_gaussian_prng()
    keys = tlwe.keygen(ring, Salsa20Stream(b"\x31" * 32), g, device=DEV)
    total = torch.zeros(ring.shape, dtype=torch.int64)
    for i in range(3):
        nonce = 100 + 3 * i
        if i == 2:
            nonce = torch.tensor(nonce, dtype=torch.int64)
        resa, resb = tlwe.encrypt_on_device(keys, ring, b"\x32" * 32, nonce,
                                            g)
        assert resa.device.type == "cpu" and resa.data.shape == ring.shape
        total += tlwe.decrypt(keys, ring, resa, resb).to(torch.int64)
    assert not bool(total.any())


@functools.lru_cache(maxsize=None)
def _jax_on_device(limb, degree, agg, exact):
    """JAX keys from a stream, its nonce after keygen, and the JAX
    package's encrypt_on_device at that nonce (run eagerly: compiling the
    exact graph takes minutes on the CPU)"""
    ring = nfl.ring_from_modulus(limb, degree, agg)
    g = jlwe.make_gaussian_prng(samples=256)
    stream = JStream(b"\x31" * 32)
    keys = jlwe.keygen(ring, stream, g)
    with jax.disable_jit():
        ra, rb = jlwe.encrypt_on_device(keys, ring, b"\x31" * 32,
                                        stream.nonce, g, exact=exact)
    arr = [np.asarray(a) for a in (keys.s.data, keys.sprime.data,
                                   keys.pka.data, keys.pkb.data)]
    return arr, stream.nonce, np.asarray(ra.data), np.asarray(rb.data)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("limb,degree,agg", [("u32", 256, 60),
                                             ("u64", 256, 124)])
def test_encrypt_on_device_matches_jax_and_host(limb, degree, agg, exact,
                                                monkeypatch):
    """Keys carried across from the JAX package: the port's
    encrypt_on_device equals the JAX package's in both formulations, and
    with exact=True it is bit-identical to the port's host encrypt() from
    a stream at the same (key, nonce), in every kernel mode."""
    keys_np, nonce, ra, rb = _jax_on_device(limb, degree, agg, exact)
    ring = _tring(limb, degree, agg)
    keys = interop.lwe_keys_from_numpy(*keys_np, ring, device=DEV)
    g = tlwe.make_gaussian_prng(samples=256)
    for mode in MODES:
        monkeypatch.setenv("NFL_TORCH_NTT", mode)
        da, db = tlwe.encrypt_on_device(keys, ring, b"\x31" * 32, nonce, g,
                                        exact=exact)
        np.testing.assert_array_equal(da.numpy(), ra)
        np.testing.assert_array_equal(db.numpy(), rb)
    if exact:
        ha, hb = tlwe.encrypt(keys, ring, Salsa20Stream(b"\x31" * 32, nonce),
                              g)
        assert ha == da and hb == db
    assert tlwe.register_gaussian(g) == tlwe._gaussian_key(
        tlwe.make_gaussian_prng(samples=256))
