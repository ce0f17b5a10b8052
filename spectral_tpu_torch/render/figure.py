"""Decorated figure rendering (optional matplotlib layer).

The core render path produces raw pixels (device colormap -> PNG). For parity
with the reference's *figures* — the 2-row shared-x layout with a signal plot
over the spectrogram, axis labels, legend, colorbar and burst overlays
(PlotEngine.py:63-66 _create_axes, :78-108 plot_extra, PlotEngine.py:134-145
_plot_spectrogram, PlotEngine.py:655-667 plot_detection_lines) — this module decorates an
AnalysisSession's state with matplotlib (Agg). matplotlib is an optional
dependency of exactly this module.

Reference styling reproduced: raw signal in blue / processed in black
(:83-86), legend upper-right (:90), jet colormap with vmin=0/vmax=1 and a
"Normalized Power" colorbar (:134-138), x-limit = max(signal, spectrogram)
duration for combined plots but the spectrogram's t[-1] for non-combined
ones (:139-143 — last_raw_t is only set by the combine branch, :200),
y-limit [fmin, f_max] (:144), burst spans in blue at
alpha 0.5 on both axes (:658-659), hover highlight blue -> red recoloring the
patch artists in place (:497-543), live drag preview as green alpha-0.3
spans at zorder 5 (:615-620).

:class:`SessionFigureView` is the interactive form: one persistent Figure
whose static layers (signal lines, pcolormesh, colorbar) are rebuilt only
when the plotted data changes, while the burst-span overlays and the drag
preview are mutated artist-by-artist per mouse event — the reference does
exactly this (set_color + remove/axvspan, never a mesh rebuild), and a
pcolormesh rebuild costs ~360 ms per motion event (SURVEY.md §6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# reference patch styling (PlotEngine.py ROI_COLOR/HOVER_COLOR usage at
# :497-543, :627-631; drag preview at :615-620)
ROI_COLOR = "blue"
DRAG_COLOR = "green"
DRAG_ALPHA = 0.3
ROI_ALPHA = 0.5


class SessionFigureView:
    """Incremental decorated-figure view over an AnalysisSession.

    Owns ONE matplotlib Figure for the lifetime of the canvas.

      * :meth:`rebuild` redraws the static layers (signal lines, pcolormesh,
        colorbar, axis limits) into the same Figure object — called only
        when the plotted data changes (plot/clear/reset).
      * :meth:`update_overlays` touches only the burst-span artists and the
        live drag preview: a pure hover change mutates the existing patch
        pair's color in place (PlotEngine.py:497-543), a span-list change
        removes/re-adds the cheap Polygon artists (plot_detection_lines
        :655-667), and an in-flight drag maintains one green preview pair
        (:615-620). The pcolormesh is never reconstructed by overlay
        updates.

    When ``animated=True`` the overlay artists are marked animated so a
    blitting canvas can restore the cached static background and draw only
    the overlays per motion event.
    """

    def __init__(self, fig=None, animated: bool = False):
        if fig is None:
            # headless default only: flipping the process-wide backend is
            # wrong when the caller hands us a figure it already embedded
            # (e.g. the Qt canvas in gui/app.py)
            import matplotlib
            matplotlib.use("Agg")
        from matplotlib.figure import Figure
        self.fig = fig if fig is not None else Figure(constrained_layout=True)
        self.animated = animated
        self.ax_signal = None
        self.ax_spec = None
        self.mesh = None                      # the pcolormesh QuadMesh
        self._spans: List[Tuple[Tuple[float, float], tuple]] = []
        self._span_colors: List[str] = []
        self._drag: Optional[Tuple[float, float]] = None
        self._drag_artists: Optional[tuple] = None

    # ---- static layers -----------------------------------------------------

    def rebuild(self, session, transparent: bool = False,
                colormap: str = "jet",
                show_spectrogram: Optional[bool] = None) -> None:
        """Redraw the static layers from the session's plot state (the
        reference's plot_extra + _plot_spectrogram, PlotEngine.py:78-145).
        Overlay state is reset; call update_overlays afterwards.

        show_spectrogram: None (default) follows the session's mode combos
        exactly like the reference (Signal/Signal draws NO spectrogram
        pane even though the headless session computed one); True/False
        override — headless callers who want the computed image regardless
        of view modes pass True."""
        fig = self.fig
        fig.clf()
        self._spans = []
        self._span_colors = []
        self._drag = None
        self._drag_artists = None
        self.mesh = None

        gs = fig.add_gridspec(nrows=2, ncols=1, height_ratios=[1, 1])
        self.ax_signal = fig.add_subplot(gs[0, 0])
        self.ax_spec = fig.add_subplot(gs[1, 0], sharex=self.ax_signal)
        ax_signal, ax_spec = self.ax_signal, self.ax_spec

        fs = session.last_fs
        if session.signal_raw is not None and fs:
            t = np.arange(len(session.signal_raw)) / fs
            ax_signal.plot(t, session.signal_raw, color="blue", label="Raw")
        if session.signal_proc is not None and fs:
            t = np.arange(len(session.signal_proc)) / fs
            ax_signal.plot(t, session.signal_proc, color="black",
                           label="Processed")
        # the stretch-x-to-signal-duration policy applies ONLY to combined
        # plots: the reference's last_raw_t is set by the combine branch
        # alone (PlotEngine.py:200), so plot_extra:91-92 / the
        # max(t[-1], last_raw_t[-1]) at :139-143 are no-ops for
        # non-combined plots, whose x-limit clips to the spectrogram's t[-1]
        sig_dur = getattr(session, "last_signal_t_end", None)
        if ax_signal.has_data():
            ax_signal.set_ylabel("Amplitude")
            if not transparent:
                leg = ax_signal.legend(loc="upper right", frameon=True)
                leg.set_zorder(100)
            if sig_dur is not None:  # plot_extra:91-92
                ax_signal.set_xlim(0, sig_dur)

        # the spectrogram pane is gated on the mode combos exactly like the
        # reference (plot_extra:96-103: no Spectrogram/Both mode selected
        # -> no source_candidate -> no spectrogram drawn), even though the
        # headless session computes an image regardless for detection and
        # export (session.py "headless default")
        v = getattr(session, "view", None)
        want_spec = show_spectrogram
        if want_spec is None:
            want_spec = v is None or (
                (v.mode_proc in ("Spectrogram", "Both")
                 and session.signal_proc is not None)
                or (v.mode_raw in ("Spectrogram", "Both")
                    and session.signal_raw is not None))
        if want_spec and session.last_image is not None \
                and session.last_t.size:
            f, t_ax = session.last_f, session.last_t
            self.mesh = ax_spec.pcolormesh(t_ax, f, session.last_image,
                                           shading="auto", cmap=colormap,
                                           vmin=0.0, vmax=1.0, zorder=0)
            ax_spec.set_ylabel("Frequency (Hz)")
            ax_spec.set_xlabel("Time (s)")
            if not transparent:
                fig.colorbar(self.mesh, ax=ax_spec, orientation="vertical",
                             label="Normalized Power")
            max_time = max(t_ax[-1], sig_dur) if sig_dur is not None \
                else t_ax[-1]
            ax_spec.set_xlim(0, max_time)
            fmin = session.config.fmin \
                if session.config and session.config.fmin else 0.0
            ax_spec.set_ylim(fmin, f[-1])

    # ---- overlay layer -------------------------------------------------------

    def _add_span(self, t0: float, t1: float, color: str, alpha: float,
                  zorder: int) -> tuple:
        pair = (self.ax_signal.axvspan(t0, t1, color=color, alpha=alpha,
                                       zorder=zorder),
                self.ax_spec.axvspan(t0, t1, color=color, alpha=alpha,
                                     zorder=zorder))
        if self.animated:
            for a in pair:
                a.set_animated(True)
        return pair

    def update_overlays(self, patches: Sequence[Tuple[float, float]],
                        colors: Optional[Sequence[str]] = None,
                        drag_span: Optional[Tuple[float, float]] = None
                        ) -> None:
        """Reconcile the burst spans + drag preview with controller state.

        Feed ``RoiEditorController.patches() / patch_colors() / drag_span``
        straight in. A hover-only change recolors the existing artists in
        place; anything else removes/re-adds just the affected Polygon
        artists. The static layers (in particular the pcolormesh) are
        untouched.
        """
        if self.ax_signal is None:
            return
        patches = [tuple(p) for p in patches]
        colors = list(colors) if colors is not None \
            else [ROI_COLOR] * len(patches)

        if [ev for ev, _ in self._spans] == patches:
            # geometry unchanged: mutate colors in place (hover highlight,
            # PlotEngine.py:497-543 set_color semantics)
            for (_, pair), col, old in zip(self._spans, colors,
                                           self._span_colors):
                if col != old:
                    for a in pair:
                        a.set_color(col)
                        a.set_alpha(ROI_ALPHA)
        else:
            for _, pair in self._spans:
                for a in pair:
                    a.remove()
            self._spans = [(ev, self._add_span(ev[0], ev[1], col, ROI_ALPHA,
                                               zorder=10))
                           for ev, col in zip(patches, colors)]
        self._span_colors = colors

        if drag_span != self._drag:
            if self._drag_artists is not None:
                for a in self._drag_artists:
                    a.remove()
                self._drag_artists = None
            if drag_span is not None:
                self._drag_artists = self._add_span(
                    drag_span[0], drag_span[1], DRAG_COLOR, DRAG_ALPHA,
                    zorder=5)
            self._drag = drag_span

    def overlay_artists(self) -> list:
        """All overlay artists in draw order (for blitting draw_artist)."""
        out = []
        for _, pair in self._spans:
            out.extend(pair)
        if self._drag_artists is not None:
            out.extend(self._drag_artists)
        return out

    def span_artists(self) -> List[tuple]:
        """The committed span artist pairs, index-aligned with patches()."""
        return [pair for _, pair in self._spans]

    def drag_artists(self) -> Optional[tuple]:
        """The live drag-preview artist pair, or None when not dragging."""
        return self._drag_artists


def render_session_figure(session, path: Optional[str] = None, dpi: int = 150,
                          transparent: bool = False, colormap: str = "jet",
                          show_spectrogram: Optional[bool] = None):
    """Render the session's current plot state to a decorated figure.

    Returns the matplotlib Figure; writes PNG to `path` if given. With
    transparent=True and legends stripped this mirrors the reference's
    export_to_png_transparent (ExportManager.py:92-111) at a sane dpi.
    show_spectrogram: None follows the session's mode combos (reference
    behavior — Signal/Signal modes show no spectrogram pane); pass True
    to draw the computed image regardless.
    """
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    view = SessionFigureView(Figure(constrained_layout=True, dpi=dpi))
    view.rebuild(session, transparent=transparent, colormap=colormap,
                 show_spectrogram=show_spectrogram)
    view.update_overlays(session.last_detected_events)
    if path is not None:
        view.fig.savefig(path, format="png", dpi=dpi,
                         transparent=transparent)
    return view.fig


def render_single_signal(name: str, signal, fs: float, use_log: bool = False,
                         path: Optional[str] = None, dpi: int = 150):
    """Labeled single-axis time-domain plot of one signal.

    Parity with PlotEngine.plot_single_signal (PlotEngine.py:215-227): fresh axes,
    t = arange(n)/fs, default line, "Time (s)" / "Amplitude" labels,
    optional log y-scale. The reference never calls it internally (its
    batch export draws its own styled line, ExportManager.py:166-189 —
    mirrored in api/export.py), but it is part of PlotEngine's public
    surface, so a user migrating scripts finds it here. `name` is
    accepted for signature parity; like the reference, it does not
    appear in the drawing.

    Returns the matplotlib Figure; writes PNG to `path` if given. For a
    fast undecorated waveform raster use render.waveform instead.
    """
    import numpy as _np
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    fig = Figure(constrained_layout=True, dpi=dpi)
    ax = fig.add_subplot(111)
    t = _np.arange(len(signal)) / fs
    ax.plot(t, _np.asarray(signal))
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    if use_log:
        ax.set_yscale("log")
    if path is not None:
        fig.savefig(path, format="png", dpi=dpi)
    return fig
