"""Visualization (PyTorch counterpart of cilqr_tpu/viz.py): matplotlib
figures in place of the reference's RViz layers and figure dashboards
(algorithm/visualization/figure_plot.h, plot.h).

Everything here is numpy on the host: inputs may be tensors on any device
(or numpy arrays) of ONE scenario and plan (no batch axis). matplotlib is
imported only when a figure is drawn, so importing this module needs
none. Each function draws onto a given or new Axes/Figure and returns the
Figure; fig.savefig(...) exports it (no blocking windows).
"""

from __future__ import annotations

import numpy as np


def _np(a):
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_scenario(scn, out=None, fig=None, ax=None):
    """Road bounds, static obstacles, dynamic obstacle first frames — the
    Environment::Visualize analog (environment.cpp:184-215); optionally
    overlays a PlanOutput (coarse red / init yellow / optimized green,
    matching the reference's RViz colors, README.md:57-59)."""
    plt = _mpl()
    if ax is None:
        fig, ax = plt.subplots(figsize=(12, 9))
    lb = _np(scn.left_barrier_xy)
    rb = _np(scn.right_barrier_xy)
    ax.plot(lb[:, 0], lb[:, 1], color="0.6", lw=1)
    ax.plot(rb[:, 0], rb[:, 1], color="0.6", lw=1)
    for poly, ok in zip(_np(scn.static_obs), _np(scn.static_mask)):
        if ok:
            ax.fill(poly[:, 0], poly[:, 1], color="m", alpha=0.6)
    for k, ok in enumerate(_np(scn.dyn_mask)):
        if ok:
            poly = _np(scn.dyn_obs)[k, 0]
            ax.fill(poly[:, 0], poly[:, 1], color="c", alpha=0.35)
    if out is not None:
        ax.plot(_np(out.coarse.x), _np(out.coarse.y), "r-",
                lw=1.5, label="coarse (DP)")
        ax.plot(_np(out.solve.init_xs)[:, 0],
                _np(out.solve.init_xs)[:, 1], "y-", lw=1.5,
                label="init guess (LQR)")
        ax.plot(_np(out.solve.xs)[:, 0],
                _np(out.solve.xs)[:, 1], "g-", lw=2,
                label="optimized (CILQR)")
        ax.legend(loc="best")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax.figure


def plot_corridors(cors, ax, every=5):
    """Corridor polygons (PlotConvexPolygon analog)."""
    polys = _np(cors.polygons)
    masks = _np(cors.poly_mask)
    for i in range(0, polys.shape[0], every):
        p = polys[i][masks[i]]
        if len(p) >= 3:
            ax.fill(p[:, 0], p[:, 1], facecolor="none", edgecolor="c",
                    lw=0.7, alpha=0.8)
    return ax.figure


def plot_states_dashboard(traj, veh, fig=None):
    """7-subplot state/control-vs-limits dashboard
    (FigurePlot::Plot, figure_plot.h:24-130)."""
    plt = _mpl()
    t = _np(traj.time)
    panels = [
        ("v [m/s]", _np(traj.velocity), (0.0, veh.max_velocity)),
        ("a [m/s^2]", _np(traj.a),
         (veh.min_acceleration, veh.max_acceleration)),
        ("jerk [m/s^3]", _np(traj.jerk), (veh.jerk_min, veh.jerk_max)),
        ("delta [rad]", _np(traj.delta), (veh.delta_min, veh.delta_max)),
        ("delta_rate [rad/s]", _np(traj.delta_rate),
         (veh.delta_rate_min, veh.delta_rate_max)),
        ("theta [rad]", _np(traj.theta), None),
        ("kappa [1/m]", _np(traj.kappa), None),
    ]
    fig, axes = plt.subplots(len(panels), 1, figsize=(10, 14), sharex=True)
    for ax, (name, vals, lims) in zip(axes, panels):
        ax.plot(t, vals, "b-")
        if lims is not None:
            ax.axhline(lims[0], color="r", ls="--", lw=0.8)
            ax.axhline(lims[1], color="r", ls="--", lw=0.8)
        ax.set_ylabel(name)
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("t [s]")
    return fig


def plot_iteration_overlays(xs_hist, n_iters, ax=None, coarse=None):
    """Per-iteration trajectory overlays (FigurePlot::Plot iteration
    figure, figure_plot.h:267-453): each accepted iterate drawn light-to-
    dark, optional coarse trajectory in red. xs_hist: [I+1, N, 6] from
    solve_with_history(record_trajs=True)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(12, 9))
    xs_hist = _np(xs_hist)
    n = min(int(n_iters) + 1, xs_hist.shape[0])
    if coarse is not None:
        ax.plot(_np(coarse.x), _np(coarse.y), "r-", lw=1.2,
                label="coarse (DP)")
    cmap = plt.get_cmap("viridis")
    for i in range(n):
        ax.plot(xs_hist[i, :, 0], xs_hist[i, :, 1],
                color=cmap(i / max(n - 1, 1)), lw=0.9,
                label="init" if i == 0 else
                ("final" if i == n - 1 else None))
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best")
    return ax.figure


def _box_corners(cx, cy, theta, length, width):
    """Corners [4, 2] of an oriented box, CCW (geometry.box_corners)."""
    hl, hw = length / 2.0, width / 2.0
    lx = np.array([hl, -hl, -hl, hl])
    ly = np.array([hw, hw, -hw, -hw])
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([cx + c * lx - s * ly, cy + s * lx + c * ly], axis=-1)


def _vehicle_patches(x, y, theta, delta, veh):
    """Vehicle body box + 4 tire boxes at a pose (the RViz playback's
    GenerateBox + tire boxes, planning_node.cc:127-145). Returns a list
    of [4, 2] corner arrays (body first)."""
    cx = x + (veh.length / 2.0 - veh.rear_hang_length) * np.cos(theta)
    cy = y + (veh.length / 2.0 - veh.rear_hang_length) * np.sin(theta)
    patches = [_box_corners(cx, cy, theta, veh.length, veh.width)]
    tire_l, tire_w = 0.4, 0.2
    half_track = 0.75 * veh.width / 2.0
    # rear tires (heading theta), front tires (heading theta + delta)
    for along, lat, ang in ((0.0, half_track, theta),
                            (0.0, -half_track, theta),
                            (veh.wheel_base, half_track, theta + delta),
                            (veh.wheel_base, -half_track, theta + delta)):
        tx = x + along * np.cos(theta) - lat * np.sin(theta)
        ty = y + along * np.sin(theta) + lat * np.cos(theta)
        patches.append(_box_corners(tx, ty, ang, tire_l, tire_w))
    return patches


def _dyn_polygon_at(dyn_obs, dyn_times, dyn_mask, dyn_len, k, t):
    """Obstacle k's polygon at time t and whether it is active: the first
    sample with timestamp > t (world._dyn_polygons_at with eps=0)."""
    L = int(dyn_len[k])
    times = dyn_times[k, :max(L, 1)]
    idx = min(max(int(np.searchsorted(times, t, side="right")), 0),
              max(L - 1, 0))
    active = bool(dyn_mask[k]) and times[0] <= t <= times[-1]
    return dyn_obs[k, idx], active


def animate_plan(scn, out, cfg, path, every: int = 1, dpi: int = 80):
    """Animated playback of a plan result — the PlanCallback animation
    (planning_node.cc:82-112): per-knot dynamic obstacles at knot time,
    the knot's corridor polygon, and the vehicle body + tire boxes
    traversing the optimized trajectory. Writes a GIF to `path`."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    from matplotlib import animation
    import matplotlib.pyplot as plt

    xs = _np(out.solve.xs)
    dyn = [_np(a) for a in (scn.dyn_obs, scn.dyn_times, scn.dyn_mask,
                            scn.dyn_len)]
    N = xs.shape[0]
    dt = cfg.delta_t
    veh = cfg.vehicle

    fig, ax = plt.subplots(figsize=(10, 8))
    plot_scenario(scn, ax=ax)
    ax.plot(xs[:, 0], xs[:, 1], "g-", lw=1.2)
    dyn_artists = []
    patch_artists = []
    corr_artist = None

    frames = list(range(0, N, every))

    def draw(i):
        nonlocal corr_artist
        k = frames[i]
        t = k * dt
        for a in dyn_artists + patch_artists:
            a.remove()
        dyn_artists.clear()
        patch_artists.clear()
        if corr_artist is not None:
            corr_artist.remove()
            corr_artist = None
        for kk in range(dyn[0].shape[0]):
            p, active = _dyn_polygon_at(*dyn, kk, t)
            if active:
                dyn_artists.append(ax.fill(p[:, 0], p[:, 1], color="c",
                                           alpha=0.45)[0])
        polys = _np(out.corridors.polygons[k])
        pmask = _np(out.corridors.poly_mask[k])
        pc = polys[pmask]
        if len(pc) >= 3:
            corr_artist = ax.fill(pc[:, 0], pc[:, 1], facecolor="none",
                                  edgecolor="b", lw=1.0)[0]
        for corners in _vehicle_patches(xs[k, 0], xs[k, 1], xs[k, 2],
                                        xs[k, 5], veh):
            patch_artists.append(ax.fill(corners[:, 0], corners[:, 1],
                                         color="0.2", alpha=0.9)[0])
        return dyn_artists + patch_artists

    anim = animation.FuncAnimation(fig, draw, frames=len(frames),
                                   interval=1000 * dt * every * 1.5)
    anim.save(path, writer=animation.PillowWriter(
        fps=max(1, int(1.0 / (dt * every * 1.5)))), dpi=dpi)
    plt.close(fig)
    return path


def plot_cost_history(hist, fig=None):
    """Cost-vs-iteration curve by component
    (figure_plot.h:455-485)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(9, 6))
    for name in ("total", "target", "dynamic", "corridor", "lane"):
        ax.plot(_np(getattr(hist, name)), label=name)
    ax.set_xlabel("iteration")
    ax.set_ylabel("cost")
    ax.legend()
    ax.grid(alpha=0.3)
    return fig
