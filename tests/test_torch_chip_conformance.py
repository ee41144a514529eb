"""``chip_smoke.py``'s conformance group on the CPU.

The group takes the conformance fuzz's seeded geometries through every
kernel of the port on the card.  Here it runs on the ``torch`` backend
(the kernels' plain versions) and on the mesh backends over
``virtual_devices(8, "cpu")``, so every byte check of the group runs
(numpy, hashlib, the plain versions, the raises), and the launches it
expects each path to make are held to what its legs must launch on the
card.  The cells are also checked to be the fuzz's own: the same seeds
give the same geometries as ``tests/test_conformance_fuzz.py`` draws.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chunky_bits_tpu_torch.ops.backend import get_backend
from chunky_bits_tpu_torch.ops.mesh_backend import MeshBackend
from chunky_bits_tpu_torch.parallel.backend import MeshCudaBackend
from chunky_bits_tpu_torch.utils.virtualmesh import virtual_devices
from tests.test_torch_file import bounded


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's intra-op workers spin: many tiny applies under xdist run
    far slower on its default thread count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_cells_are_the_fuzz_geometries():
    rs = {c["tag"]: c for c in cs.conf_rs_cells()}
    assert len(rs) == 20
    for seed in range(8):
        rng = np.random.default_rng(seed)
        d, p = int(rng.integers(1, 17)), int(rng.integers(0, 9))
        size, batch = int(rng.integers(1, 3000)), int(rng.integers(1, 5))
        cell = rs[f"random{seed}"]
        assert cell["data"].shape == (batch, d, size) and cell["p"] == p
        assert np.array_equal(cell["data"], rng.integers(
            0, 256, (batch, d, size), dtype=np.uint8))
    pm = {c["tag"]: c for c in cs.conf_pm_cells()}
    assert len(pm) == 14
    assert pm["pmxor1"]["data"].shape[1:] == (6, 1280) \
        and pm["pmxor1"]["p"] == 8
    for cell in cs.conf_aligned(rs["xor0"]), cs.conf_aligned(rs["mesh2"]):
        assert cell["data"].shape[2] % 256 == 0
    assert [len(cs.conf_lengths(s)) for s in (6, 8)] == [6, 6]


def test_phase_conformance_on_the_cpu():
    be = get_backend("torch")
    devices = virtual_devices(8, "cpu")
    mesh_rec = cs.DispatchRecorder(MeshBackend(devices=devices))
    tp_rec = cs.DispatchRecorder(MeshCudaBackend("dp2,tp4", devices=devices))
    ran = []

    def path(name, fn, *args):
        ran.append(name)
        return fn(*args)

    expected = bounded(lambda: cs.phase_conformance(
        torch, torch.device("cpu"), path, be, mesh_rec, tp_rec), 240)
    assert ran == list(expected) == [
        "conf_cuda", "conf_packed", "conf_mesh", "conf_tp", "conf_pm_msr",
        "conf_device_sha", "conf_objects", "conf_raise"]
    # on the card each leg launches the kernels it exists for, and the
    # raises launch nothing
    assert expected["conf_cuda"]["gf_apply"] > 0
    assert expected["conf_packed"]["gf_apply_packed"] > 0
    assert expected["conf_packed"]["gf_apply"] > 0
    assert expected["conf_tp"]["gf_acc"] > 0
    assert expected["conf_tp"]["gf_acc_pack"] > 0
    assert expected["conf_mesh"]["gf_apply"] > 0
    assert expected["conf_pm_msr"]["gf_apply"] > 0
    assert expected["conf_device_sha"]["sha256_rows"] == \
        expected["conf_device_sha"]["gf_apply"] > 0
    assert expected["conf_objects"]["gf_apply"] > 0
    assert sum(expected["conf_raise"].values()) == 0
    for want in expected.values():
        assert set(want) == set(cs.KERNELS)
