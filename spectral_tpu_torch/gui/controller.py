"""Headless GUI controllers: every interaction the reference implements in
Qt/matplotlib callbacks, factored into toolkit-free state machines.

The reference entangles its interaction logic with the canvas (PlotEngine is
a FigureCanvas subclass, PlotEngine.py:11; mouse handlers at :480-667) and
the main window (GUI.py:170-586). Here the Qt layer only translates widget
events into calls on these controllers, so the full interaction surface —
drag-drawn ROI spans, hover highlighting, the right-click Delete/Merge menu,
mode combos, Refine Model, the editing gate, band-power dialogs, batch
export, persistent combine registration — is unit-testable without a display
(tests/test_gui_controller.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

Event = Tuple[float, float]

# patch display colors (PlotEngine.py:497-543: hover turns blue -> red)
COLOR_NORMAL = "blue"
COLOR_HOVER = "red"


class RoiEditorController:
    """Mouse-driven ROI editing state machine (PlotEngine.py:480-667).

    The canvas feeds data-space x coordinates and button codes (1=left,
    3=right, matplotlib convention); the controller mutates the session's
    ROI/event lists through its pure ops (core/events.py) and reports what
    changed so the view can redraw.

    Reference semantics reproduced:
      * editing toggle arms/disarms all handlers (set_editing_enabled,
        PlotEngine.py:480-495);
      * hover over a patch highlights it blue -> red (:497-543);
      * left-drag draws a new paired span on both axes; on release the span
        is committed with a minimum width of one sample (:608-645, min
        width :627-631);
      * right-click on a hovered patch offers Delete / Merge (:553-606);
        Merge unions every patch geometrically contained in the hovered one
        (:567-599).
    """

    def __init__(self, session, on_change: Optional[Callable[[], None]] = None):
        self.session = session
        self.on_change = on_change or (lambda: None)
        self.editing = False
        self.hover: Optional[int] = None          # index into patches()
        self.drag_origin: Optional[float] = None
        self.drag_span: Optional[Event] = None    # live preview while dragging

    # ---- state the view renders ------------------------------------------

    def patches(self) -> List[Event]:
        """The spans currently drawn (detections + manual ROIs share one
        list, as the reference's burst_patches does, PlotEngine.py:641)."""
        return list(self.session.last_detected_events)

    def patch_colors(self) -> List[str]:
        return [COLOR_HOVER if i == self.hover else COLOR_NORMAL
                for i in range(len(self.patches()))]

    # ---- editing gate ------------------------------------------------------

    def set_editing_enabled(self, enabled: bool) -> None:
        """PlotEngine.set_editing_enabled (:480-495): disarming also cancels
        any in-flight drag and clears the hover highlight."""
        was = self.editing
        self.editing = bool(enabled)
        if was and not self.editing:
            # only a real disarm notifies: disabling an already-disabled
            # editor has nothing to cancel, and each notification is a full
            # overlay reconcile + canvas draw (plot_selected calls this
            # twice around every plot)
            self.drag_origin = None
            self.drag_span = None
            if self.hover is not None:
                self.hover = None
            self.on_change()

    # ---- mouse handlers ----------------------------------------------------

    def _hit(self, x: float) -> Optional[int]:
        for i, (t0, t1) in enumerate(self.patches()):
            if t0 <= x <= t1:
                return i
        return None

    def on_press(self, x: Optional[float], button: int = 1) -> Optional[str]:
        """Returns 'drag' when a span drag starts, 'menu' when a context
        menu should open on the hovered patch, None otherwise."""
        if not self.editing or x is None:
            return None
        if button == 3:                           # right click (:553-558)
            prev = self.hover
            self.hover = self._hit(x)
            if self.hover is not None:
                self.on_change()
                return "menu"
            if prev is not None:  # clearing the hover must also re-render,
                self.on_change()  # or the old red highlight goes stale
            return None
        if button == 1:
            self.drag_origin = float(x)
            self.drag_span = (float(x), float(x))
            return "drag"
        return None

    def on_motion(self, x: Optional[float]) -> bool:
        """Update the drag preview or the hover highlight; returns True if
        the view should redraw."""
        if not self.editing or x is None:
            return False
        if self.drag_origin is not None:          # live span preview (:615-620)
            self.drag_span = (min(self.drag_origin, float(x)),
                              max(self.drag_origin, float(x)))
            self.on_change()
            return True
        new_hover = self._hit(x)                  # hover highlight (:497-543)
        if new_hover != self.hover:
            self.hover = new_hover
            self.on_change()
            return True
        return False

    def on_release(self, x: Optional[float]) -> Optional[Event]:
        """Commit the dragged span (min width = one sample, :627-631).
        Returns the committed (start, end) or None."""
        if not self.editing or self.drag_origin is None:
            return None
        x0 = self.drag_origin
        x1 = float(x) if x is not None else x0
        self.drag_origin = None
        self.drag_span = None
        start, end = min(x0, x1), max(x0, x1)
        before = len(self.session.last_detected_events)
        self.session.add_roi(start, end)
        added = self.session.last_detected_events[-1] \
            if len(self.session.last_detected_events) > before else None
        self.on_change()
        return added

    # ---- context-menu actions (:553-606) -----------------------------------

    def context_actions(self) -> List[str]:
        return ["Delete", "Merge"] if self.hover is not None else []

    def delete_hovered(self) -> bool:
        if self.hover is None:
            return False
        roi = self.patches()[self.hover]
        self.session.delete_roi(roi)
        self.hover = None
        self.on_change()
        return True

    def merge_hovered(self) -> bool:
        """Union every patch geometrically contained in the hovered patch
        (PlotEngine.py:567-599). A no-op merge (nothing contained) keeps
        the hover highlight and triggers no redraw — the reference's
        early return at :578-580; only a fired merge clears it (:602)."""
        if self.hover is None:
            return False
        before = list(self.session.last_detected_events)
        container = self.patches()[self.hover]
        self.session.merge_rois(container)
        if self.session.last_detected_events == before:
            return False
        self.hover = None
        self.on_change()
        return True


class WindowController:
    """Headless logic of the reference main window (GUI.py:12-586) that is
    not already in AnalysisSession: button gating, Refine Model delegation,
    band-power dialog text, batch export, persistent combine registration."""

    def __init__(self, session):
        self.session = session
        self.roi_editor = RoiEditorController(session)

    # ---- editing gate for buttons (GUI.py:314-323) --------------------------

    def set_editing_enabled(self, enabled: bool) -> None:
        self.roi_editor.set_editing_enabled(enabled)

    def can_learn(self) -> bool:
        """'Learn from Examples' needs editing ON and >= 1 patch
        (GUI.py:286-312 preconditions + :314-323 gating)."""
        return self.roi_editor.editing and bool(self.roi_editor.patches())

    def can_refine(self) -> bool:
        return self.can_learn()

    # ---- Refine Model (GUI.py:278-284: delegates to learn_and_detect) -------

    def refine_model(self) -> List[Event]:
        if not self.roi_editor.patches():
            raise ValueError(
                "No regions to refine from — draw or detect bursts first.")
        return self.session.learn_and_detect(self.roi_editor.patches())

    # ---- band-power dialog (GUI.py:529-566) ----------------------------------

    def band_powers_report(self, bands=None) -> str:
        """The dialog body: one 'name: xx.xx %' line per EEG band plus the
        absolute total, mirroring the reference's modal text."""
        powers = self.session.calculate_band_powers(bands)
        if powers is None:
            raise ValueError("Please plot a spectrogram first.")
        total = self.session.calculate_absolute_power()
        lines = [f"{name}: {frac * 100.0:.2f} %"
                 for name, frac in powers.items()]
        lines.append(f"Total absolute power: {total:.6g}")
        return "\n".join(lines)

    # ---- persistent combine (GUI.py:226-276) ---------------------------------

    def register_combined(self, names: Sequence[str]) -> str:
        """Concatenate the named sweeps into a new persistent 'combineN'
        registry entry holding BOTH combined streams (the reference writes
        straight into manager.data, GUI.py:260-267; the <2-sweep guard is
        :228-230)."""
        if len(names) < 2:
            raise ValueError("Select at least two sweeps to combine.")
        return self.session.registry.register_combined(list(names))

    # ---- batch export (GUI.py:577-586) ----------------------------------------

    def export_batch(self, out_dir: str, names: Sequence[str],
                     use_proc: bool, use_raw: bool) -> str:
        if not names:
            raise ValueError("Select sweeps to export.")
        return self.session.export_batch_png(out_dir, list(names),
                                             use_proc=use_proc,
                                             use_raw=use_raw)
