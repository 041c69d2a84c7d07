"""Standalone 2-D physics explorer panels (counterpart of
radarays_ros_tpu/viz/explore.py, after the reference's
scripts/reflections/{fresnel,snell_multi}.py, scripts/radaray_beams.py and
scripts/radarays_snell_fresnel_brdf.py).

Four explorations as figures drawn from the data helpers (viz/brdf.py,
viz/reflections.py, viz/beams.py), which run the port's own wave physics,
the code the simulator runs. Each `panel_*` function returns (data_dict,
figure_or_None); the three `interactive_*` explorers return (fig, update)
with live sliders. The data functions take `device` (default the card);
matplotlib is imported only to draw, so the data path never needs it.
`python -m radarays_ros_tpu_torch.io.cli explore` is the command.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# validated categorical order (identity = medium/series), light surface
_SERIES = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948")
_INK = "#333333"
_MUTED = "#8a8a8a"


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def _mpl_gui():
    """pyplot WITHOUT forcing Agg — the interactive explorers want
    whatever GUI backend the user's environment provides (matplotlib
    falls back to Agg headlessly, where the sliders still construct and
    respond to programmatic set_val — that is what the tests drive)."""
    import matplotlib.pyplot as plt
    return plt


def _style_axis(ax):
    ax.grid(True, color=_MUTED, alpha=0.25, linewidth=0.6)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(_MUTED)
    ax.tick_params(colors=_INK, labelsize=8)


def panel_brdf(ambient: float, diffuse: float, specular: float,
               plot: bool = False, device="cuda"
               ) -> Tuple[Dict, Optional[object]]:
    """Back-reflection energy vs incidence angle (the A + B*cos^C shader)."""
    from radarays_ros_tpu_torch.viz.brdf import brdf_curve

    data = brdf_curve(ambient, diffuse, specular, device=device)
    fig = None
    plt = _mpl() if plot else None
    if plt is not None:
        fig, ax = plt.subplots(figsize=(5.2, 3.4), dpi=120)
        ang = np.degrees(data["angle_rad"])
        ax.plot(ang, data["energy"], color=_SERIES[0], linewidth=2.0)
        ax.set_xlabel("incidence angle [deg]", color=_INK, fontsize=9)
        ax.set_ylabel("returned energy fraction", color=_INK, fontsize=9)
        ax.set_title(
            f"back-reflection shader  A={ambient:g} B={diffuse:g} "
            f"C={specular:g}", color=_INK, fontsize=10)
        _style_axis(ax)
        fig.tight_layout()
    return data, fig


def panel_fresnel(v1: float, v2: float, polarization: float = 0.5,
                  plot: bool = False, device="cuda"
                  ) -> Tuple[Dict, Optional[object]]:
    """Reff/Teff split and refraction angle vs incidence angle.

    Two stacked panels (energy fraction and refraction angle are different
    quantities — never a dual axis).
    """
    from radarays_ros_tpu_torch.viz.brdf import fresnel_curve

    data = fresnel_curve(v1, v2, polarization, device=device)
    fig = None
    plt = _mpl() if plot else None
    if plt is not None:
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(5.2, 5.4), dpi=120,
                                       sharex=True)
        ang = np.degrees(data["angle_rad"])
        ax1.plot(ang, data["reflectance"], color=_SERIES[0], linewidth=2.0,
                 label="Reff")
        ax1.plot(ang, data["transmittance"], color=_SERIES[1], linewidth=2.0,
                 label="Teff")
        ax1.set_ylabel("energy fraction", color=_INK, fontsize=9)
        ax1.set_title(
            f"Fresnel split  v1={v1:g} v2={v2:g} m/ns  pol={polarization:g}",
            color=_INK, fontsize=10)
        ax1.legend(frameon=False, fontsize=8, labelcolor=_INK)
        _style_axis(ax1)
        refr = np.asarray(data["refraction_angle_deg"], float)
        ax2.plot(ang, refr, color=_SERIES[2], linewidth=2.0)
        tir = np.asarray(data["total_internal_reflection"], bool)
        if tir.any():
            ax2.axvspan(float(ang[tir.argmax()]), float(ang[-1]),
                        color=_MUTED, alpha=0.15, linewidth=0)
            ax2.text(float(ang[tir.argmax()]), np.nanmax(refr) * 0.5,
                     " total internal reflection", color=_INK, fontsize=8)
        ax2.set_xlabel("incidence angle [deg]", color=_INK, fontsize=9)
        ax2.set_ylabel("refraction angle [deg]", color=_INK, fontsize=9)
        _style_axis(ax2)
        fig.tight_layout()
    return data, fig


def panel_slab(depths: Sequence[float], velocities: Sequence[float],
               origin=(0.0, 1.0), direction=(0.6, -0.8), n_bounces: int = 4,
               polarization: float = 0.5, plot: bool = False,
               device="cuda") -> Tuple[Dict, Optional[object]]:
    """2-D reflect/refract ray tree through a stack of media interfaces
    (scripts/reflections/snell_multi.py). Segment color = medium identity
    (fixed categorical order); opacity = carried energy."""
    from radarays_ros_tpu_torch.viz.reflections import propagate_slab_rays

    data = propagate_slab_rays(depths, velocities, origin=origin,
                               direction=direction, n_bounces=n_bounces,
                               polarization=polarization, device=device)
    fig = None
    plt = _mpl() if plot else None
    if plt is not None:
        fig, ax = plt.subplots(figsize=(5.6, 4.2), dpi=120)
        xs = [s["p0"][0] for s in data["segments"]] + \
            [s["p1"][0] for s in data["segments"]] or [0.0, 1.0]
        x_lo, x_hi = min(xs) - 0.1, max(xs) + 0.1
        for d in depths:
            ax.hlines(d, x_lo, x_hi, color=_MUTED, alpha=0.6,
                      linewidth=1.0)
        seen = set()
        for s in data["segments"]:
            m = int(s["medium"])
            label = f"medium {m} (v={velocities[m]:g})" \
                if m not in seen else None
            seen.add(m)
            ax.plot([s["p0"][0], s["p1"][0]], [s["p0"][1], s["p1"][1]],
                    color=_SERIES[m % len(_SERIES)], linewidth=2.0,
                    alpha=float(np.clip(0.25 + 0.75 * s["energy"], 0, 1)),
                    label=label)
        for leak in data["leaks"]:
            p0 = np.asarray(leak["p0"])
            d = np.asarray(leak["dir"])
            p1 = p0 + 0.3 * d
            ax.plot([p0[0], p1[0]], [p0[1], p1[1]], linestyle=":",
                    color=_SERIES[int(leak["medium"]) % len(_SERIES)],
                    linewidth=1.4,
                    alpha=float(np.clip(0.25 + 0.75 * leak["energy"], 0, 1)))
        ax.set_xlabel("x [m]", color=_INK, fontsize=9)
        ax.set_ylabel("depth [m]", color=_INK, fontsize=9)
        ax.set_title(f"slab reflect/refract tree, {n_bounces} bounces",
                     color=_INK, fontsize=10)
        if len(seen) >= 2:
            ax.legend(frameon=False, fontsize=8, labelcolor=_INK)
        ax.set_aspect("equal", adjustable="datalim")
        _style_axis(ax)
        fig.tight_layout()
    return data, fig


def interactive_brdf(ambient: float = 1.0, diffuse: float = 0.0,
                     specular: float = 3000.0, device="cuda"):
    """Live slider explorer for the back-reflection shader — the
    interactive analog of the reference's radarays_snell_fresnel_brdf.py
    BRDF pane (README.md:41-49). Returns (fig, update) where update(...)
    is also callable programmatically (tests drive it headlessly)."""
    from matplotlib.widgets import Slider

    from radarays_ros_tpu_torch.viz.brdf import brdf_curve

    plt = _mpl_gui()
    fig, ax = plt.subplots(figsize=(6.0, 4.4), dpi=110)
    fig.subplots_adjust(bottom=0.32)
    data = brdf_curve(ambient, diffuse, specular, device=device)
    ang = np.degrees(data["angle_rad"])
    (line,) = ax.plot(ang, data["energy"], color=_SERIES[0], linewidth=2.0)
    ax.set_xlabel("incidence angle [deg]", color=_INK, fontsize=9)
    ax.set_ylabel("returned energy fraction", color=_INK, fontsize=9)
    _style_axis(ax)

    axs = [fig.add_axes([0.16, y, 0.7, 0.035]) for y in (0.18, 0.115, 0.05)]
    s_amb = Slider(axs[0], "ambient", 0.0, 2.0, valinit=ambient)
    s_dif = Slider(axs[1], "diffuse", 0.0, 2.0, valinit=diffuse)
    s_spe = Slider(axs[2], "specular", 1.0, 5000.0, valinit=specular)

    def update(_=None):
        d = brdf_curve(s_amb.val, s_dif.val, s_spe.val, device=device)
        line.set_ydata(d["energy"])
        ax.relim(); ax.autoscale_view()
        fig.canvas.draw_idle()

    for s in (s_amb, s_dif, s_spe):
        s.on_changed(update)
    fig._sliders = (s_amb, s_dif, s_spe)  # keep refs alive
    return fig, update


def interactive_fresnel(v1: float = 0.3, v2: float = 0.15,
                        polarization: float = 0.5, device="cuda"):
    """Live slider explorer for the Snell/Fresnel split — the interactive
    analog of scripts/reflections/fresnel.py. Sliders: v1, v2 [m/ns] and
    the s/p polarization mix. Returns (fig, update)."""
    from matplotlib.widgets import Slider

    from radarays_ros_tpu_torch.viz.brdf import fresnel_curve

    plt = _mpl_gui()
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(6.0, 6.2), dpi=110,
                                   sharex=True)
    fig.subplots_adjust(bottom=0.26)
    data = fresnel_curve(v1, v2, polarization, device=device)
    ang = np.degrees(data["angle_rad"])
    (l_r,) = ax1.plot(ang, data["reflectance"], color=_SERIES[0],
                      linewidth=2.0, label="Reff")
    (l_t,) = ax1.plot(ang, data["transmittance"], color=_SERIES[1],
                      linewidth=2.0, label="Teff")
    ax1.set_ylabel("energy fraction", color=_INK, fontsize=9)
    ax1.legend(fontsize=8)
    (l_a,) = ax2.plot(ang, np.asarray(data["refraction_angle_deg"], float),
                      color=_SERIES[2], linewidth=2.0)
    ax2.set_xlabel("incidence angle [deg]", color=_INK, fontsize=9)
    ax2.set_ylabel("refraction angle [deg]", color=_INK, fontsize=9)
    for ax in (ax1, ax2):
        _style_axis(ax)

    axs = [fig.add_axes([0.16, y, 0.7, 0.03]) for y in (0.15, 0.095, 0.04)]
    s_v1 = Slider(axs[0], "v1 [m/ns]", 0.01, 0.3, valinit=v1)
    s_v2 = Slider(axs[1], "v2 [m/ns]", 0.0, 0.3, valinit=v2)
    s_p = Slider(axs[2], "polarization", 0.0, 1.0, valinit=polarization)

    def update(_=None):
        d = fresnel_curve(s_v1.val, s_v2.val, s_p.val, device=device)
        l_r.set_ydata(d["reflectance"])
        l_t.set_ydata(d["transmittance"])
        l_a.set_ydata(np.asarray(d["refraction_angle_deg"], float))
        for ax in (ax1, ax2):
            ax.relim(); ax.autoscale_view()
        fig.canvas.draw_idle()

    for s in (s_v1, s_v2, s_p):
        s.on_changed(update)
    fig._sliders = (s_v1, s_v2, s_p)
    return fig, update


def interactive_beams(width_deg: float = 8.0, n_samples: int = 2000,
                      p_in_cone: float = 0.8, seed: int = 0, device="cuda"):
    """Live slider explorer for the cone sampling distributions D1-D4 —
    the interactive analog of scripts/radaray_beams.py. Sliders: beam
    width and p_in_cone. Returns (fig, update)."""
    from matplotlib.widgets import Slider

    from radarays_ros_tpu_torch.viz.beams import beam_panel

    plt = _mpl_gui()
    fig, axes = plt.subplots(2, 2, figsize=(6.6, 7.0), dpi=110,
                             sharex=True, sharey=True)
    fig.subplots_adjust(bottom=0.18)
    theta = np.linspace(0, 2 * np.pi, 181)

    scatters, rings, titles = [], [], []
    data = beam_panel(width_deg, n_samples, p_in_cone, seed,
                      device=device)
    half = np.deg2rad(width_deg) / 2.0
    for ax, (name, d) in zip(axes.ravel(), data.items()):
        sc = ax.scatter(d["beta"], d["alpha"], s=2.5, color=_SERIES[0],
                        alpha=0.35, linewidths=0)
        (ring,) = ax.plot(half * np.cos(theta), half * np.sin(theta),
                          color=_MUTED, linewidth=1.0, alpha=0.8)
        ti = ax.set_title(f"{name}  in-cone {d['frac_in_cone']:.2f}",
                          color=_INK, fontsize=9)
        ax.set_aspect("equal")
        _style_axis(ax)
        scatters.append(sc); rings.append(ring); titles.append(ti)

    axs = [fig.add_axes([0.16, y, 0.7, 0.03]) for y in (0.085, 0.03)]
    s_w = Slider(axs[0], "width [deg]", 0.5, 30.0, valinit=width_deg)
    s_p = Slider(axs[1], "p_in_cone", 0.5, 0.999, valinit=p_in_cone)

    def update(_=None):
        d_all = beam_panel(s_w.val, n_samples, s_p.val, seed,
                           device=device)
        h = np.deg2rad(s_w.val) / 2.0
        lim = h * 2.2
        for sc, ring, ti, (name, d) in zip(scatters, rings, titles,
                                           d_all.items()):
            sc.set_offsets(np.column_stack([d["beta"], d["alpha"]]))
            ring.set_data(h * np.cos(theta), h * np.sin(theta))
            ti.set_text(f"{name}  in-cone {d['frac_in_cone']:.2f}")
        for ax in axes.ravel():
            ax.set_xlim(-lim, lim); ax.set_ylim(-lim, lim)
        fig.canvas.draw_idle()

    for s in (s_w, s_p):
        s.on_changed(update)
    fig._sliders = (s_w, s_p)
    return fig, update


_INTERACTIVE = {"brdf": interactive_brdf, "fresnel": interactive_fresnel,
                "beams": interactive_beams}


def panel_beams(width_deg: float = 8.0, n_samples: int = 2000,
                p_in_cone: float = 0.8, seed: int = 0, plot: bool = False,
                device="cuda") -> Tuple[Dict, Optional[object]]:
    """The four cone sample distributions D1..D4 as small multiples
    (scripts/radaray_beams.py:63-101)."""
    from radarays_ros_tpu_torch.viz.beams import beam_panel

    data = beam_panel(width_deg, n_samples, p_in_cone, seed,
                      device=device)
    fig = None
    plt = _mpl() if plot else None
    if plt is not None:
        fig, axes = plt.subplots(2, 2, figsize=(6.4, 6.4), dpi=120,
                                 sharex=True, sharey=True)
        half = np.deg2rad(width_deg) / 2.0
        theta = np.linspace(0, 2 * np.pi, 181)
        for ax, (name, d) in zip(axes.ravel(), data.items()):
            ax.scatter(d["beta"], d["alpha"], s=2.5, color=_SERIES[0],
                       alpha=0.35, linewidths=0)
            ax.plot(half * np.cos(theta), half * np.sin(theta),
                    color=_MUTED, linewidth=1.0, alpha=0.8)
            ax.set_title(f"{name}  in-cone {d['frac_in_cone']:.2f}",
                         color=_INK, fontsize=9)
            ax.set_aspect("equal")
            _style_axis(ax)
        for ax in axes[-1]:
            ax.set_xlabel("yaw offset [rad]", color=_INK, fontsize=8)
        for ax in axes[:, 0]:
            ax.set_ylabel("pitch offset [rad]", color=_INK, fontsize=8)
        fig.suptitle(f"cone sampling, width {width_deg:g} deg, "
                     f"p_in_cone {p_in_cone:g}", color=_INK, fontsize=10)
        fig.tight_layout()
    return data, fig
