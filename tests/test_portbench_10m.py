"""The benchmark's kaist02-10m deployment on the CPU, at a tiny size that
keeps what the 10M map forces: prep group 4.

At full size the port's rule picks group 4 for that map; a tiny map would
get group 1. So these cases set the group and build enough chunks (700
boxes in chunks of 8: 1,056 chunks, 264 supergroups) that K3 and K2 test
supergroup boxes and K1 walks four chunks a supergroup. The cell's tiny
window is held against the plain reference (portbench/reference/frame.py)
under the cell's own check and limits, and the TF32 control and the
planted frame faults fail that check there.
"""

import numpy as np
import pytest

from portbench import check as CK
from portbench import generator as G
from portbench.tests.test_portbench_harness import (SEED, SPEC,
                                                    _frames_fault, run_tiny,
                                                    tiny_config,
                                                    tiny_traffic)
from radarays_ros_tpu_torch.geom.scene import padded_chunks
from radarays_ros_tpu_torch.trace import cuda_trace as CT

CELL = "kaist02-10m.stream20"


def full_prep_group(conf: dict) -> int:
    """The prep group the port's rule picks for the configuration's map at
    full size (an urban map: 12 triangles a box and 2 of ground)."""
    s = conf["scene"]
    return CT._auto_prep_group(padded_chunks(2 + 12 * s["n_buildings"],
                                             s["chunk_size"]))


def grouped_config() -> dict:
    """The 10M cell's configuration at the tiny size, at the prep group its
    full-size map takes."""
    conf = SPEC.config(SPEC.workload(CELL)["config"])
    c = tiny_config(conf)
    c["scene"].update(n_buildings=700, chunk_size=8)
    c["radar"]["trace_prep_group"] = full_prep_group(conf)
    return c


def test_the_10m_map_is_the_1m_deployment_at_a_larger_scale():
    small, big = SPEC.config("kaist02-1m"), SPEC.config("kaist02-10m")
    for k in ("radar", "materials", "object_materials", "beam_width_deg",
              "trajectory", "reference"):
        assert big[k] == small[k], k
    assert {k for k in small["scene"]
            if big["scene"][k] != small["scene"][k]} == {"n_buildings",
                                                         "extent"}
    assert full_prep_group(big) == 4 and full_prep_group(small) == 1
    assert padded_chunks(2 + 12 * 700, 8) // 4 == 264


def test_tiny_window_at_prep_group_4_agrees_with_the_reference(monkeypatch):
    """Every K1 call of the window runs at group 4, each after K3 builds
    its coarse words over the supergroup boxes, and the window passes the
    cell's check."""
    groups, coarse = [], []
    real_plain, real_coarse = CT._sweep_plain, CT.coarse_words

    def plain(*a, group, **k):
        groups.append(group)
        return real_plain(*a, group=group, **k)

    def counted(slo, *a):
        coarse.append(slo.shape[0])
        return real_coarse(slo, *a)

    monkeypatch.setattr(CT, "_sweep_plain", plain)
    monkeypatch.setattr(CT, "coarse_words", counted)
    out = run_tiny(CELL, conf=grouped_config())
    assert out["correct"], out["check"]
    assert out["failed"] == 0
    assert groups and set(groups) == {4}
    assert len(coarse) == len(groups)


def test_tf32_control_fails_the_10m_frame_comparison():
    conf = grouped_config()
    w = SPEC.workload(CELL)
    cell = G.kind("frames").Cell(
        conf, tiny_traffic(SPEC.traffic(w["traffic"])), SEED, "cpu")
    win = cell.window(0.0, 0)
    rows, u8, mv, _ = CK.frame_rows(win.kept, 24, 24,
                                    np.random.default_rng(0), "cpu")
    soup, om = cell.sys.soup, cell.sys.object_materials
    ref = CK.reference_columns(conf, soup, om, rows, "cpu")
    ctl = CK.reference_columns(conf, soup, om, rows, "cpu", tf32=True)
    limits = SPEC.limits(CELL)
    prog = CK.frame_numbers(u8, mv, *ref)
    assert all(prog[k] <= limits[k] for k in prog), prog
    control = CK.frame_numbers(*ctl, *ref)
    assert any(control[k] > limits[k] for k in control), control


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_planted_frame_fault_at_prep_group_4_is_not_correct(fault,
                                                            monkeypatch):
    from radarays_ros_tpu_torch.sim import pipeline as P

    name, fn = _frames_fault(fault)
    monkeypatch.setattr(P, name, fn)
    out = run_tiny(CELL, conf=grouped_config())
    assert not out["correct"], out["check"]
