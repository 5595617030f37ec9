"""Plotting helpers: a small grammar-of-graphics-ish qplot over pandas
DataFrames. Functional equivalent of reference tramp/experiments/plots.py
(aes palette l:55-70, qplot l:118-220)."""
import itertools

import numpy as np

AES_PALETTE = {
    "linestyle": ["-", "--", "-.", ":"],
    "marker": [".", "x", "+", "o", "v", "^", "<", ">", "s", "D"],
    "color": [f"C{i}" for i in range(10)],
}


def _unique(data, field):
    return sorted(data[field].unique())


def qplot(data, x, y, color=None, column=None, row=None, marker=None,
          linestyle=None, xlog=False, ylog=False, xlim=None, ylim=None,
          y_markers=None, sharex=True, sharey=True, figsize=4,
          y_legend=False, rename=None, font_size=12, usetex=False):
    "Faceted line plot: facets by row/column, series by color/marker/linestyle."
    import matplotlib.pyplot as plt

    y_multiple = isinstance(y, list)
    if y_multiple and (not isinstance(y_markers, list)
                       or len(y) != len(y_markers)):
        raise ValueError("y_markers must be a list of same length as y")
    plt.rc("font", size=font_size)

    rows = _unique(data, row) if row else [None]
    cols = _unique(data, column) if column else [None]
    nrows, ncols = len(rows), len(cols)
    if isinstance(figsize, (int, float)):
        figsize = (figsize * ncols, figsize * nrows)
    fig, axs = plt.subplots(nrows, ncols, squeeze=False, figsize=figsize,
                            sharex=sharex, sharey=sharey)

    series_fields = [(aes, f) for aes, f in
                     [("color", color), ("marker", marker),
                      ("linestyle", linestyle)] if f]
    fields = [f for _, f in series_fields]
    choices = [_unique(data, f) for f in fields]

    for i, rv in enumerate(rows):
        for j, cv in enumerate(cols):
            ax = axs[i, j]
            df = data
            title = ""
            if row:
                df = df[df[row] == rv]
                title += f"{row}={rv} "
            if column:
                df = df[df[column] == cv]
                title += f"{column}={cv}"
            if title:
                ax.set_title(title)
            for combo in itertools.product(*choices) if fields else [()]:
                sub = df
                opts, label = {}, ""
                for (aes, f), val in zip(series_fields, combo):
                    sub = sub[sub[f] == val]
                    opts[aes] = AES_PALETTE[aes][
                        _unique(data, f).index(val) % len(AES_PALETTE[aes])]
                    label += f"{f}={val} "
                if len(sub) == 0:
                    continue
                if y_multiple:
                    for y_var, y_marker in zip(y, y_markers):
                        lbl = (label + " " + y_var) if y_legend else y_var
                        ax.plot(sub[x], sub[y_var], y_marker, label=lbl,
                                **{k: v for k, v in opts.items()
                                   if k != "marker"})
                else:
                    ax.plot(sub[x], sub[y], label=label.strip() or None,
                            **opts)
            if xlog:
                ax.set_xscale("log")
            if ylog:
                ax.set_yscale("log")
            if xlim:
                ax.set_xlim(xlim)
            if ylim:
                ax.set_ylim(ylim)
            ax.set_xlabel(x)
            if not y_multiple:
                ax.set_ylabel(y)
            if fields or y_multiple:
                ax.legend()
    fig.tight_layout()
    return fig


def plot_function(f, xmin=-5, xmax=5, n=200, ax=None, **kwargs):
    import matplotlib.pyplot as plt
    xs = np.linspace(xmin, xmax, n)
    ys = [float(f(x)) for x in xs]
    ax = ax or plt.gca()
    ax.plot(xs, ys, **kwargs)
    return ax


def plot_compare(x_true, x_pred, ax=None, labels=("true", "pred")):
    import matplotlib.pyplot as plt
    ax = ax or plt.gca()
    ax.plot(np.asarray(x_true), label=labels[0])
    ax.plot(np.asarray(x_pred), "--", label=labels[1])
    ax.legend()
    return ax


def plot_compare_complex(x_true, x_pred, ax=None):
    import matplotlib.pyplot as plt
    ax = ax or plt.gca()
    # unpack the packed re/im planes host-side in numpy
    xt, xp = np.asarray(x_true), np.asarray(x_pred)
    zt = xt[0] + 1j * xt[1]
    zp = xp[0] + 1j * xp[1]
    ax.scatter(zt.real, zt.imag, marker="o", label="true", alpha=0.6)
    ax.scatter(zp.real, zp.imag, marker="x", label="pred", alpha=0.6)
    ax.legend()
    return ax
