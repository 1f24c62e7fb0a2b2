"""Spectrum plot rendering (port of `mpbp_tpu/utils/plots.py`): the
eigenvalue scatter plots of a `drivers.spectrum_report` as an image file.
Host-side only; matplotlib is imported inside the function, so the
package works without it.
"""

from __future__ import annotations


def render_spectrum_report(report: dict, path: str) -> str:
    """Render a `drivers.spectrum_report` dict to a scatter figure at
    `path` (format from the extension, e.g. .png): one panel for spec(A),
    one per preconditioned operator with the unit point and the clustering
    radius drawn."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pcs = list(report.get("preconditioned", {}))
    n_panels = 1 + len(pcs)
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4.4),
                             squeeze=False)
    axes = axes[0]

    def scatter(ax, spec, title):
        ax.scatter(spec["eigenvalues_re"], spec["eigenvalues_im"], s=18,
                   alpha=0.75, edgecolors="none")
        ax.axhline(0, color="0.85", lw=0.8, zorder=0)
        ax.axvline(0, color="0.85", lw=0.8, zorder=0)
        ax.set_title(title, fontsize=10)
        ax.set_xlabel("Re λ")
        ax.set_ylabel("Im λ")

    scatter(axes[0], report["A"], f"spec(A), n={report['n']}")
    for ax, kind in zip(axes[1:], pcs):
        spec = report["preconditioned"][kind]
        scatter(ax, spec, f"spec(A·M⁻¹), pc={kind}")
        r = spec.get("clustering_radius_1")
        ax.plot([1.0], [0.0], marker="+", ms=12, color="tab:red", mew=1.5)
        if r is not None and r != float("inf"):
            ax.add_patch(plt.Circle((1.0, 0.0), r, fill=False,
                                    color="tab:red", lw=1.0, ls="--"))
            ax.set_title(f"spec(A·M⁻¹), pc={kind}\n"
                         f"clustering radius {r:.3g}"
                         + (f", {spec['n_nullspace']} nullspace"
                            if spec.get("n_nullspace") else ""),
                         fontsize=10)

    p = report.get("params", {})
    fig.suptitle(
        f"multiphase Stokes spectra — η_n={p.get('eta_n')}, "
        f"η_s={p.get('eta_s')}, ξ={p.get('xi')} "
        f"({report.get('method', '?')} spectrum)", fontsize=11)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
