"""Visualization helpers (counterpart of
``pytorch_toolbelt_tpu/utils/visualization.py``, whose host code it copies;
parity target: pytorch_toolbelt/utils/visualization.py:25-342).

matplotlib renders with the Agg backend; figures can be converted to HWC
arrays for TensorBoard-style logging.
"""

from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "plot_confusion_matrix",
    "plot_compressed_confusion_matrix",
    "plot_heatmap",
    "render_figure_to_tensor",
    "hstack_autopad",
    "vstack_autopad",
    "vstack_header",
    "grid_stack",
]


def _cell_text_color(value, norm, cmap) -> str:
    """Contrast-aware annotation color: sample the colormap at the cell's
    normalized value and pick black/white by perceived luminance of the
    actual cell color (Rec. 601 weights) — robust for any colormap, unlike
    a data-midpoint threshold."""
    r, g, b, _ = cmap(norm(value))
    luminance = 0.299 * r + 0.587 * g + 0.114 * b
    return "white" if luminance < 0.5 else "black"


def plot_heatmap(
    cm: np.ndarray,
    title: str,
    x_label: Optional[str] = None,
    y_label: Optional[str] = None,
    x_ticks: Optional[List[str]] = None,
    y_ticks: Optional[List[str]] = None,
    format_string: Optional[str] = None,
    show_scores: bool = True,
    fontsize: int = 12,
    figsize: Tuple[int, int] = (16, 16),
    fname: Optional[str] = None,
    noshow: bool = False,
    cmap=None,
    backend: str = "Agg",
):
    """Render a 2D array as an annotated heatmap figure.

    Capability target: pytorch_toolbelt/utils/visualization.py:40-92
    (`plot_heatmap`) — same call signature, independent implementation on
    the matplotlib axes-object API with luminance-based annotation
    contrast instead of the reference's data-midpoint rule.
    """
    cm = np.asarray(cm)
    if cm.ndim != 2:
        raise ValueError("Heatmap must be a 2-D array")
    import matplotlib

    matplotlib.use(backend)
    import matplotlib.pyplot as plt

    if cmap is None:
        cmap = matplotlib.colormaps["Oranges"]
    elif isinstance(cmap, str):
        cmap = matplotlib.colormaps[cmap]

    fig, ax = plt.subplots(figsize=figsize)
    mesh = ax.imshow(cm, interpolation="nearest", cmap=cmap)
    ax.set_title(title)
    if x_label is not None:
        ax.set_xlabel(x_label)
    if y_label is not None:
        ax.set_ylabel(y_label)
    fig.colorbar(mesh, ax=ax, shrink=0.82)

    if x_ticks is not None:
        ax.set_xticks(range(len(x_ticks)), labels=x_ticks, rotation=45, ha="right")
    if y_ticks is not None:
        ax.set_yticks(range(len(y_ticks)), labels=y_ticks)

    if show_scores:
        if format_string is None:
            format_string = ".2f" if np.issubdtype(cm.dtype, np.floating) else "d"
        for (row, col), value in np.ndenumerate(cm):
            ax.annotate(
                format(value, format_string) if np.isfinite(value) else "N/A",
                xy=(col, row),
                ha="center",
                va="center",
                fontsize=fontsize,
                color=_cell_text_color(value, mesh.norm, cmap),
            )

    fig.tight_layout()
    if fname is not None:
        fig.savefig(fname, dpi=200)
    if not noshow:
        plt.show()
    return fig


def plot_confusion_matrix(
    cm: np.ndarray,
    class_names: List[str],
    figsize: Tuple[int, int] = (16, 16),
    fontsize: int = 12,
    normalize: bool = False,
    title: str = "Confusion matrix",
    fname: Optional[str] = None,
    noshow: bool = False,
    backend: str = "Agg",
    format_string: Optional[str] = None,
):
    """Annotated confusion-matrix figure with accuracy in the footer."""
    cm = np.asarray(cm)
    if normalize:
        with np.errstate(all="ignore"):
            cm = cm.astype(np.float32) / cm.sum(axis=1, keepdims=True)
        accuracy_note = ""
    else:
        accuracy = np.trace(cm) / (float(np.sum(cm)) + 1e-8)
        accuracy_note = f"\nAccuracy={accuracy:0.4f}; Misclass={1 - accuracy:0.4f}"

    f = plot_heatmap(
        cm,
        title=title,
        x_label="Predicted label" + accuracy_note,
        y_label="True label",
        x_ticks=class_names,
        y_ticks=class_names,
        format_string=format_string,
        fontsize=fontsize,
        figsize=figsize,
        fname=fname,
        noshow=noshow,
        backend=backend,
    )
    return f


def plot_compressed_confusion_matrix(
    cm: np.ndarray,
    figsize: Tuple[int, int] = (16, 16),
    normalize: bool = False,
    title: str = "Confusion matrix",
    cmap=None,
    fname: Optional[str] = None,
    noshow: bool = False,
    backend: str = "Agg",
):
    """Image-only confusion-matrix figure: no per-cell annotations or class
    tick labels, so it stays readable (and fast to render) for hundreds of
    classes.  Parity target: pytorch_toolbelt/utils/visualization.py:94-131.
    """
    cm = np.asarray(cm)
    if normalize:
        with np.errstate(all="ignore"):
            cm = cm.astype(np.float32) / cm.sum(axis=1, keepdims=True)
        x_label = "Predicted label"
    else:
        accuracy = np.trace(cm) / (float(np.sum(cm)) + 1e-8)
        x_label = f"Predicted label\nAccuracy={accuracy:0.4f}; Misclass={1 - accuracy:0.4f}"

    return plot_heatmap(
        cm,
        title=title,
        x_label=x_label,
        y_label="True label",
        show_scores=False,
        figsize=figsize,
        fname=fname,
        noshow=noshow,
        cmap=cmap,
        backend=backend,
    )


def render_figure_to_tensor(figure) -> np.ndarray:
    """Rasterize a matplotlib figure to an HWC uint8 array
    (reference visualization.py:241-266 returns CHW; channels-last here)."""
    import matplotlib.pyplot as plt

    figure.canvas.draw()
    image = np.asarray(figure.canvas.buffer_rgba())[..., :3].copy()
    plt.close(figure)
    return image


def hstack_autopad(images: List[np.ndarray], pad_value: int = 0) -> np.ndarray:
    """Horizontally stack images of different heights with bottom padding."""
    max_h = max(img.shape[0] for img in images)
    padded = []
    for img in images:
        pad = [(0, max_h - img.shape[0]), (0, 0)] + [(0, 0)] * (img.ndim - 2)
        padded.append(np.pad(img, pad, constant_values=pad_value))
    return np.concatenate(padded, axis=1)


def vstack_autopad(images: List[np.ndarray], pad_value: int = 0) -> np.ndarray:
    """Vertically stack images of different widths with right padding."""
    max_w = max(img.shape[1] for img in images)
    padded = []
    for img in images:
        pad = [(0, 0), (0, max_w - img.shape[1])] + [(0, 0)] * (img.ndim - 2)
        padded.append(np.pad(img, pad, constant_values=pad_value))
    return np.concatenate(padded, axis=0)


def vstack_header(image: np.ndarray, title: str, size: int = 36, bg_color=(40, 40, 40), text_color=(242, 248, 248)) -> np.ndarray:
    """Prepend a title bar above an image."""
    header = np.full((size, image.shape[1], 3), bg_color, dtype=np.uint8)
    try:
        import cv2

        cv2.putText(
            header, title, (10, size - 12), cv2.FONT_HERSHEY_PLAIN, 1.5, text_color, 1, cv2.LINE_AA
        )
    except ImportError:
        pass
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    return vstack_autopad([header, image])


def grid_stack(images: List[np.ndarray], rows: int, cols: int, pad_value: int = 0) -> np.ndarray:
    """Arrange images into a rows x cols grid."""
    if rows * cols < len(images):
        raise ValueError(f"Grid {rows}x{cols} cannot fit {len(images)} images")
    row_images = []
    for r in range(rows):
        chunk = images[r * cols : (r + 1) * cols]
        if not chunk:
            break
        row_images.append(hstack_autopad(chunk, pad_value))
    return vstack_autopad(row_images, pad_value)
