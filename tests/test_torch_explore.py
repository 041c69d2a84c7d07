"""The port's physics explorer (radarays_ros_tpu_torch.viz: brdf.py,
reflections.py, beams.py, explore.py, and the CLI's `explore`) against the
JAX package's, on the CPU.

The curves and the slab tree run the same f32 wave physics in both
packages and are held within 1e-6, with the same segment and leak
structure. The beam panel draws from torch generators, not JAX's threefry,
so it is held by the reference's statistics (tests/test_viz.py:74-89).
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from radarays_ros_tpu.io import cli as jcli
from radarays_ros_tpu.viz import brdf as jbrdf
from radarays_ros_tpu.viz import reflections as jrefl

from radarays_ros_tpu_torch.io import cli as pcli
from radarays_ros_tpu_torch.viz import explore
from radarays_ros_tpu_torch.viz.beams import beam_panel
from radarays_ros_tpu_torch.viz.brdf import brdf_curve, fresnel_curve
from radarays_ros_tpu_torch.viz.reflections import propagate_slab_rays

torch.set_num_threads(2)

TOL = 1e-6


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=TOL, atol=atol, equal_nan=True)


def _curves_close(got, want, atol=TOL):
    assert set(got) == set(want)
    for k in want:
        if k == "total_internal_reflection":
            assert got[k] == want[k]
        else:
            _close(got[k], want[k], atol)


def _brdf_atol(diffuse, specular):
    """TOL, plus one f32 ulp of cos (torch's and XLA's may round it apart)
    carried through cos**specular and scaled by diffuse: the shader's
    ambient + diffuse * cos**specular amplifies it specular-fold."""
    return TOL + diffuse * specular * 2.0 ** -23


def _tree_close(got, want):
    """The same segments and leaks, in the same order and media, with
    positions, directions and energies within TOL."""
    for part, keys in (("segments", ("p0", "p1", "energy")),
                       ("leaks", ("p0", "dir", "energy"))):
        assert len(got[part]) == len(want[part])
        for a, b in zip(got[part], want[part]):
            assert a["medium"] == b["medium"]
            for k in keys:
                _close(a[k], b[k])


@pytest.mark.parametrize("abc", [(1.0, 0.2, 30.0), (0.2, 0.5, 100.0),
                                 (1.0, 0.0, 3000.0)])
def test_brdf_curve_matches_reference(abc):
    got = brdf_curve(*abc, device="cpu")
    _curves_close(got, jbrdf.brdf_curve(*abc), _brdf_atol(*abc[1:]))
    e = np.asarray(got["energy"])
    assert np.all(np.diff(e) <= 1e-6)


@pytest.mark.parametrize("v1,v2,pol", [(0.3, 0.15, 0.5), (0.15, 0.3, 0.5),
                                       (0.3, 0.0, 0.2), (0.3, 0.1, 1.0)])
def test_fresnel_curve_matches_reference(v1, v2, pol):
    """Entering a slower medium, leaving into a faster one (total internal
    reflection beyond the critical angle), an opaque medium, and pure
    p-polarization."""
    got = fresnel_curve(v1, v2, pol, device="cpu")
    _curves_close(got, jbrdf.fresnel_curve(v1, v2, pol))
    np.testing.assert_allclose(np.add(got["reflectance"],
                                      got["transmittance"]), 1.0, atol=1e-5)
    assert any(got["total_internal_reflection"]) == (v2 > v1 or v2 == 0.0)


@pytest.mark.parametrize("kw", [
    dict(depths=[0.0, -0.2], velocities=[0.3, 0.15, 0.3],
         origin=(0.0, 0.5), direction=(0.6, -0.8), n_bounces=3),
    dict(depths=[0.0, -0.5], velocities=[0.3, 0.15, 0.3],
         origin=(0.0, -0.25), direction=(0.94, 0.34), n_bounces=1),
    dict(depths=[0.0, -0.2, -0.7], velocities=[0.3, 0.1, 0.2, 0.05],
         origin=(-0.3, 1.0), direction=(0.3, -0.9), n_bounces=5,
         polarization=0.8),
    dict(depths=[0.0], velocities=[0.3, 0.0], direction=(1.0, 0.0))])
def test_slab_tree_matches_reference(kw):
    """The reference's slab and total-internal-reflection cases, a three-
    interface stack five bounces deep, and a ray parallel to the interface
    (a leak at once)."""
    got = propagate_slab_rays(**kw, device="cpu")
    want = jrefl.propagate_slab_rays(**kw)
    _tree_close(got, want)
    assert got["segments"] or got["leaks"]


def test_beam_panel_statistics():
    """tests/test_viz.py:74-89 on the port's draws; the draws are the
    port's own (each distribution from its own seeded generator), the same
    for the same seed and different for another."""
    panel = beam_panel(width_deg=8.0, n_samples=4000, p_in_cone=0.8, seed=1,
                       device="cpu")
    assert set(panel) == {"D1_uniform_radius", "D2_uniform_disk",
                          "D3_normal", "D4_sqrt_normal"}
    assert panel["D1_uniform_radius"]["frac_in_cone"] == pytest.approx(1.0)
    assert panel["D2_uniform_disk"]["frac_in_cone"] == pytest.approx(1.0)
    assert panel["D3_normal"]["frac_in_cone"] == pytest.approx(0.8, abs=0.03)
    h1 = np.asarray(panel["D1_uniform_radius"]["r_hist"], float)
    h2 = np.asarray(panel["D2_uniform_disk"]["r_hist"], float)
    assert h2[-8:].sum() / h2.sum() > h1[-8:].sum() / h1.sum()
    again = beam_panel(8.0, 4000, 0.8, 1, device="cpu")
    other = beam_panel(8.0, 4000, 0.8, 2, device="cpu")
    assert again == panel
    assert other["D3_normal"]["alpha"] != panel["D3_normal"]["alpha"]


def test_panels_render(tmp_path):
    """Every panel gives its data and a figure that saves."""
    pytest.importorskip("matplotlib")
    figs = [explore.panel_brdf(1.0, 0.2, 30.0, plot=True, device="cpu"),
            explore.panel_fresnel(0.15, 0.3, plot=True, device="cpu"),
            explore.panel_slab([0.0, -0.2], [0.3, 0.15, 0.3], plot=True,
                               device="cpu"),
            explore.panel_beams(n_samples=200, plot=True, device="cpu")]
    for i, (data, fig) in enumerate(figs):
        assert data and fig is not None
        fig.savefig(tmp_path / f"panel{i}.png")
        assert (tmp_path / f"panel{i}.png").stat().st_size > 1000
    import matplotlib.pyplot as plt
    plt.close("all")


def test_interactive_explorers_drive_sliders():
    """The slider explorers recompute through the port's physics on a
    slider move, driven headlessly (tests/test_viz.py:199-231)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")

    fig, _ = explore.interactive_brdf(1.0, 0.2, 30.0, device="cpu")
    (line,) = fig.axes[0].lines
    before = np.array(line.get_ydata(), float)
    fig._sliders[0].set_val(1.7)
    after = np.array(line.get_ydata(), float)
    assert np.all(after >= before - 1e-6) and after[0] > before[0] + 0.4

    fig2, _ = explore.interactive_fresnel(0.3, 0.15, 0.5, device="cpu")
    l_r = fig2.axes[0].lines[0]
    r_before = np.array(l_r.get_ydata(), float)
    fig2._sliders[1].set_val(0.0)
    r_after = np.array(l_r.get_ydata(), float)
    assert not np.allclose(r_before, r_after)
    np.testing.assert_allclose(r_after, 1.0, atol=1e-3)

    fig3, _ = explore.interactive_beams(8.0, n_samples=200, device="cpu")
    sc = fig3.axes[0].collections[0]
    before3 = sc.get_offsets().data.copy()
    fig3._sliders[0].set_val(20.0)
    after3 = sc.get_offsets().data
    assert np.abs(after3).max() > np.abs(before3).max() * 1.5

    import matplotlib.pyplot as plt
    plt.close("all")


_PANEL_ARGS = {
    "brdf": ["--ambient", 0.4, "--diffuse", 0.5, "--specular", 80.0],
    "fresnel": ["--v1", 0.15, "--v2", 0.3, "--polarization", 0.3],
    "slab": ["--depths", "0.0,-0.3", "--velocities", "0.3,0.12,0.3",
             "--origin", "0.1,0.8", "--direction", "0.5,-0.8",
             "--bounces", 3],
    "beams": ["--n-samples", 1500, "--beam-width", 10.0, "--seed", 2],
}


@pytest.mark.parametrize("panel", list(_PANEL_ARGS))
def test_explore_cli_matches_reference(panel, tmp_path, capsys):
    """`explore --panel P --json` for every panel: the curves and the slab
    tree equal the JAX CLI's data within 1e-6; the beams by the
    reference's statistics (their draws differ)."""
    argv = ["explore", "--panel", panel, *_PANEL_ARGS[panel]]
    argv = [str(a) for a in argv]
    assert pcli.main(argv + ["--json", str(tmp_path / "p.json"),
                             "--device", "cpu"]) == 0
    assert jcli.main(argv + ["--json", str(tmp_path / "j.json")]) == 0
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 'p.json'}" in out
    got = json.loads((tmp_path / "p.json").read_text())
    want = json.loads((tmp_path / "j.json").read_text())
    if panel == "slab":
        _tree_close(got, want)
    elif panel == "beams":
        assert set(got) == set(want)
        for k in got:
            assert len(got[k]["alpha"]) == len(want[k]["alpha"]) == 1500
            assert got[k]["r_edges"] == want[k]["r_edges"]
            assert got[k]["frac_in_cone"] == pytest.approx(
                want[k]["frac_in_cone"], abs=0.04)
    else:
        _curves_close(got, want, _brdf_atol(0.5, 80.0) if panel == "brdf"
                      else TOL)
    # without --json the data goes to stdout
    assert pcli.main(argv + ["--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == got


def test_explore_cli_errors(tmp_path, capsys, monkeypatch):
    """--interactive on the slab panel returns 2 before any device is
    asked for; --plot without matplotlib returns 1 with the reference's
    message, after writing the JSON; explore on a missing card is an
    error."""
    assert pcli.main(["explore", "--panel", "slab", "--interactive"]) == 2
    assert "no interactive mode" in capsys.readouterr().err
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rc = pcli.main(["explore", "--panel", "brdf", "--plot",
                    str(tmp_path / "f.png"), "--json",
                    str(tmp_path / "f.json"), "--device", "cpu"])
    assert rc == 1
    assert "matplotlib unavailable; --plot skipped" in capsys.readouterr().err
    assert (tmp_path / "f.json").exists() and not (tmp_path / "f.png").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pcli.main(["explore", "--panel", "fresnel"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_explore_data_path_imports_no_matplotlib(tmp_path):
    """The data path and --json never import matplotlib (the card's
    machine is not known to have it), nor jax."""
    code = (
        "import sys\n"
        "from radarays_ros_tpu_torch.io.cli import main\n"
        "for p in ('brdf', 'fresnel', 'slab', 'beams'):\n"
        f"    assert main(['explore', '--panel', p, '--json', "
        f"r'{tmp_path}/' + p + '.json', '--n-samples', '50', "
        "'--device', 'cpu']) == 0\n"
        "bad = {'matplotlib', 'jax', 'radarays_ros_tpu'} & set(sys.modules)\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    assert len(list(tmp_path.glob("*.json"))) == 4
