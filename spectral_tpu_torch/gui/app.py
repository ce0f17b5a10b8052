"""Thin Qt GUI client over the port's AnalysisSession + controllers.

Counterpart of ``spectral_tpu/gui/app.py``: the same window, widgets,
QSettings keys, status strings and dialogs, over the port's session
(``api/session.py``), which runs on the card unless the window is built
with ``device='cpu'``. ``gui/controller.py`` is the JAX package's module,
copied byte for byte.

Mirrors the reference's window (GUI.py:12-168: file tree, display options
with RAW/PROC mode combos, analysis parameters, detection buttons incl.
Refine Model and the editing toggle that gates learning, band-power dialog,
export buttons incl. batch export, persistent combine, status label) while
keeping ALL logic below the widgets: compute/state in api/session.py, every
interaction state machine in gui/controller.py (headless-tested). The GUI
only translates Qt signals into controller calls — the inversion of the
reference's design where PlotEngine was simultaneously compute engine, model
holder, renderer and Qt widget (SURVEY.md §1). Requires PyQt5 (optional
dependency; the framework is headless-first). Launch: ``python -m
spectral_tpu_torch.gui.app`` (the port's CLI arrives with ROADMAP [cli]).

Settings persist via QSettings under "spectral_tpu/SpectrogramGenerator",
mirroring the reference's keys (GUI.py:190-224: lastDir, drawRaw, drawProc,
combineAll, modeRaw, modeProc, nperseg, fmin, fmax, logScale,
lastExportDir).
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

MODES = ("Signal", "Spectrogram", "Both")   # GUI.py:38-66 combos


def _require_qt():
    try:
        from PyQt5 import QtCore, QtWidgets  # noqa: F401
        return True
    except ImportError:
        return False


def build_window(device="cuda"):
    """Construct the main window (PyQt5 required; under real Qt a
    QApplication must exist first). Separated from main() so tests can
    drive the full widget wiring against a Qt-compatible stub. ``device``
    is the session's: the card unless 'cpu' is named."""
    from PyQt5 import QtCore, QtGui, QtWidgets
    from matplotlib.backends.backend_qt5agg import (FigureCanvasQTAgg,
                                                    NavigationToolbar2QT)
    from matplotlib.figure import Figure

    from spectral_tpu_torch.api.session import AnalysisSession
    from spectral_tpu_torch.config import SpecConfig, ViewSettings
    from spectral_tpu_torch.gui.controller import WindowController
    from spectral_tpu_torch.render.figure import SessionFigureView

    class MainWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("Spectrogram Generator (TPU)")
            self.session = AnalysisSession(device=device)
            self.controller = WindowController(self.session)
            self.controller.roi_editor.on_change = self._patches_changed
            self.settings = QtCore.QSettings("spectral_tpu",
                                             "SpectrogramGenerator")

            root = QtWidgets.QWidget()
            layout = QtWidgets.QHBoxLayout(root)
            self.setCentralWidget(root)

            # left panel: file tree + controls (GUI.py:22-156)
            panel = QtWidgets.QVBoxLayout()
            layout.addLayout(panel, 1)

            self.tree = QtWidgets.QTreeWidget()
            self.tree.setHeaderLabel("Sweeps")
            self.tree.setSelectionMode(
                QtWidgets.QAbstractItemView.ExtendedSelection)
            # tree context menu: Remove Selected / Select All / Clear All
            # (GUI.py:44,173,485-494)
            self.tree.setContextMenuPolicy(QtCore.Qt.CustomContextMenu)
            self.tree.customContextMenuRequested.connect(
                self.open_tree_context_menu)
            # single-click on a sweep plots it alone: selection is reset to
            # the clicked item and Combine is unchecked first (GUI.py:174,
            # 359-372)
            self.tree.itemClicked.connect(self.on_tree_item_clicked)
            panel.addWidget(self.tree, 2)

            btn_add = QtWidgets.QPushButton("Add Files")
            btn_add.clicked.connect(self.add_files)
            panel.addWidget(btn_add)
            btn_remove = QtWidgets.QPushButton("Remove Selected")
            btn_remove.clicked.connect(self.remove_selected)  # GUI.py:49,172
            panel.addWidget(btn_remove)
            btn_comb = QtWidgets.QPushButton("Register Combined Sweep")
            btn_comb.clicked.connect(self.register_combined)
            panel.addWidget(btn_comb)

            # display options: RAW/PROC checkboxes + per-source mode combos
            # (GUI.py:38-66)
            form = QtWidgets.QFormLayout()
            self.chk_raw = QtWidgets.QCheckBox("RAW")
            self.chk_proc = QtWidgets.QCheckBox("PROC")
            self.combo_raw = QtWidgets.QComboBox()
            self.combo_raw.addItems(MODES)
            self.combo_proc = QtWidgets.QComboBox()
            self.combo_proc.addItems(MODES)
            self.chk_combine = QtWidgets.QCheckBox("Combine")
            self.chk_log = QtWidgets.QCheckBox("Log scale")
            self.spin_nperseg = QtWidgets.QSpinBox()
            self.spin_nperseg.setRange(32, 8192)
            self.spin_nperseg.setSingleStep(32)  # GUI.py:87-90
            self.spin_fmin = QtWidgets.QDoubleSpinBox()
            self.spin_fmin.setRange(0.0, 5000.0)
            self.spin_fmax = QtWidgets.QDoubleSpinBox()
            self.spin_fmax.setRange(1.0, 5000.0)  # GUI.py:99
            form.addRow(self.chk_raw, self.combo_raw)
            form.addRow(self.chk_proc, self.combo_proc)
            form.addRow(self.chk_combine, self.chk_log)
            form.addRow("nperseg", self.spin_nperseg)
            form.addRow("fmin (Hz)", self.spin_fmin)
            form.addRow("fmax (Hz)", self.spin_fmax)
            panel.addLayout(form)

            btn_plot = QtWidgets.QPushButton("Plot Signal")
            btn_plot.clicked.connect(self.plot_selected)
            panel.addWidget(btn_plot)
            btn_detect = QtWidgets.QPushButton("Auto-Detect Bursts")
            btn_detect.clicked.connect(self.detect)
            panel.addWidget(btn_detect)

            # editing toggle gates Learn/Refine (GUI.py:314-323)
            self.chk_edit = QtWidgets.QCheckBox("Enable Editing")
            self.chk_edit.toggled.connect(self.toggle_editing)
            panel.addWidget(self.chk_edit)
            self.btn_learn = QtWidgets.QPushButton("Learn from Examples")
            self.btn_learn.clicked.connect(self.learn)
            self.btn_learn.setEnabled(False)
            panel.addWidget(self.btn_learn)
            self.btn_refine = QtWidgets.QPushButton("Refine Model")
            self.btn_refine.clicked.connect(self.refine)
            self.btn_refine.setEnabled(False)
            panel.addWidget(self.btn_refine)

            for label, slot in [("Reset Model", self.reset_model),
                                ("Band Powers", self.band_powers),
                                ("Export CSV", self.export_csv),
                                ("Export PNG", self.export_png),
                                ("Batch Export PNGs", self.export_batch)]:
                b = QtWidgets.QPushButton(label)
                b.clicked.connect(slot)
                panel.addWidget(b)

            self.status = QtWidgets.QLabel("Status: Ready")  # GUI.py:159
            panel.addWidget(self.status)

            # whether the CURRENT plot requested a spectrogram pane. The
            # session computes one for every plot (headless API need), but
            # the reference's detect/learn/band-power guards key on its
            # spec_data_source/last_Sxx, which only a spectrogram-mode plot
            # sets (PlotEngine.py:95-105) — so the shell gates those
            # actions here (deviation from the reference's STALE regime is
            # deliberate and pinned: tests/test_reference_gui_differential
            # .py::test_signal_only_replot_stale_power_quirk)
            self._spec_plotted = False

            # right: incremental figure view + matplotlib canvas fed from
            # the headless session. The view owns ONE persistent Figure:
            # plot/clear/reset rebuild its static layers, mouse events only
            # mutate the burst-span overlay artists (render/figure.py) —
            # never the pcolormesh (the reference works the same way,
            # PlotEngine.py:497-543/:615-620; a mesh rebuild costs ~360 ms).
            self.view = SessionFigureView(Figure(constrained_layout=True))
            self.fig = self.view.fig
            self.canvas = FigureCanvasQTAgg(self.fig)
            # blit when the canvas supports it: the static layers render
            # once into a cached background and motion events repaint only
            # the overlay artists
            self._blit = all(hasattr(self.canvas, m) for m in
                             ("copy_from_bbox", "restore_region", "blit"))
            self.view.animated = self._blit
            self._bg = None
            right = QtWidgets.QVBoxLayout()
            right.addWidget(NavigationToolbar2QT(self.canvas, self))
            right.addWidget(self.canvas)
            layout.addLayout(right, 3)
            self._connect_canvas()

            self.load_settings()

        # ---- settings (GUI.py:190-224 semantics) -----------------------
        def load_settings(self):
            s = self.settings
            self.chk_raw.setChecked(s.value("drawRaw", True, bool))
            self.chk_proc.setChecked(s.value("drawProc", True, bool))
            self.chk_combine.setChecked(s.value("combineAll", False, bool))
            self.chk_log.setChecked(s.value("logScale", False, bool))
            self.combo_raw.setCurrentText(s.value("modeRaw", "Signal", str))
            self.combo_proc.setCurrentText(s.value("modeProc", "Signal", str))
            self.spin_nperseg.setValue(s.value("nperseg", 1024, int))
            self.spin_fmin.setValue(s.value("fmin", 0.0, float))
            self.spin_fmax.setValue(s.value("fmax", 30.0, float))
            for w, key in [(self.chk_raw, "drawRaw"),
                           (self.chk_proc, "drawProc"),
                           (self.chk_combine, "combineAll"),
                           (self.chk_log, "logScale")]:
                w.toggled.connect(lambda v, k=key: self.settings.setValue(k, v))
            self.combo_raw.currentTextChanged.connect(
                lambda v: self.settings.setValue("modeRaw", v))
            self.combo_proc.currentTextChanged.connect(
                lambda v: self.settings.setValue("modeProc", v))
            self.spin_nperseg.valueChanged.connect(
                lambda v: self.settings.setValue("nperseg", v))
            self.spin_fmin.valueChanged.connect(
                lambda v: self.settings.setValue("fmin", v))
            self.spin_fmax.valueChanged.connect(
                lambda v: self.settings.setValue("fmax", v))

        # ---- interactive ROI editing: canvas -> controller ----------------
        def _connect_canvas(self):
            c = self.canvas
            c.mpl_connect("button_press_event", self._on_press)
            c.mpl_connect("motion_notify_event", self._on_motion)
            c.mpl_connect("button_release_event", self._on_release)
            if self._blit:
                # canonical blitting recipe: every full draw (first render,
                # resize, toolbar actions) recaptures the static background
                # and repaints the animated overlay artists on top
                c.mpl_connect("draw_event", self._on_draw)

        def _on_draw(self, event):
            self._bg = self.canvas.copy_from_bbox(self.fig.bbox)
            for a in self.view.overlay_artists():
                a.axes.draw_artist(a)

        def _xdata(self, event):
            """PlotEngine._get_correct_xdata (PlotEngine.py:46-61): when the event is
            inside an axes but carries no data coordinate, recover it by
            inverse-transforming the pixel position."""
            ax = getattr(event, "inaxes", None)
            if ax is None:
                return None
            if event.xdata is not None:
                return event.xdata
            try:
                inv = ax.transData.inverted()
                xdata, _ = inv.transform((event.x, event.y))
                return xdata
            except Exception:
                return None

        def _on_press(self, event):
            button = int(event.button) if event.button else 1
            action = self.controller.roi_editor.on_press(self._xdata(event),
                                                         button)
            if action == "menu":
                menu = QtWidgets.QMenu(self)
                for name in self.controller.roi_editor.context_actions():
                    menu.addAction(name)
                chosen = menu.exec_(QtGui.QCursor.pos())
                if chosen is not None:
                    if chosen.text() == "Delete":
                        self.controller.roi_editor.delete_hovered()
                    elif chosen.text() == "Merge":
                        self.controller.roi_editor.merge_hovered()

        def _on_motion(self, event):
            self.controller.roi_editor.on_motion(self._xdata(event))

        def _on_release(self, event):
            self.controller.roi_editor.on_release(self._xdata(event))

        def _patches_changed(self):
            # overlay-only change (hover, drag preview, add/delete/merge):
            # reconcile the span artists and blit — the pcolormesh and the
            # rest of the figure are untouched
            ed = self.controller.roi_editor
            self.view.update_overlays(ed.patches(), ed.patch_colors(),
                                      ed.drag_span)
            if self._blit and self._bg is not None:
                self.canvas.restore_region(self._bg)
                for a in self.view.overlay_artists():
                    a.axes.draw_artist(a)
                self.canvas.blit(self.fig.bbox)
            else:
                self.canvas.draw()
            self._update_gates()

        def _update_gates(self):
            # the reference enables Learn/Refine from the checkbox ALONE
            # (GUI.py:318-319,:322-323); empty-patch/no-plot cases warn at
            # click time (:279-283,:288-294), not by disabling the buttons.
            # Read the CHECKBOX, not the controller flag — plot_selected
            # suspends the controller's editing mid-replot while the
            # checkbox (the user-visible mode) stays checked
            on = self.chk_edit.isChecked()
            self.btn_learn.setEnabled(on)
            self.btn_refine.setEnabled(on)

        def toggle_editing(self, enabled):
            """GUI.py:314-323 — gate the learn buttons and announce the
            mode with the reference's exact status strings."""
            self.controller.set_editing_enabled(enabled)
            self._update_gates()
            if enabled:
                self.status.setText(
                    "Status: Manual editing enabled. Left-click drag to "
                    "add/move, right-click to remove.")
            else:
                self.status.setText("Status: Manual editing disabled.")

        # ---- actions ----------------------------------------------------
        def _selected_names(self):
            return [i.data(0, QtCore.Qt.UserRole)
                    for i in self.tree.selectedItems()]

        def _add_tree_item(self, name):
            item = QtWidgets.QTreeWidgetItem([name])
            item.setData(0, QtCore.Qt.UserRole, name)
            self.tree.addTopLevelItem(item)

        def add_files(self):
            last = self.settings.value("lastDir", "", str)
            paths, _ = QtWidgets.QFileDialog.getOpenFileNames(
                self, "Add Files", last,
                "All (*.abf *.h5 *.nix *.wav *.npz);;ABF (*.abf);;"
                "HDF5/NIX (*.h5 *.nix);;WAV (*.wav);;NPZ (*.npz)")
            for p in paths:
                self.settings.setValue("lastDir", os.path.dirname(p))
                try:
                    for name in self.session.load(p):
                        self._add_tree_item(name)
                    # per-file status + error box text (GUI.py:341-343)
                    self.status.setText(
                        f"Status: Loaded {os.path.basename(p)}")
                except Exception as e:
                    QtWidgets.QMessageBox.critical(
                        self, "Load Error", f"Error loading {p}:\n{e}")

        def register_combined(self):
            """Persistent combine into the registry (GUI.py:226-276) —
            both streams are combined regardless of the RAW/PROC
            checkboxes, and the status reports the max amplitude across
            them (:251-252, :275)."""
            names = self._selected_names()
            if len(names) < 2:  # GUI.py:228-230
                QtWidgets.QMessageBox.warning(
                    self, "Need More Sweeps",
                    "Please select at least two sweeps to combine.")
                return
            try:
                new = self.controller.register_combined(names)
                self._add_tree_item(new)
                entry = self.session.registry.data[new]
                amplitude = max(float(np.max(np.abs(entry.raw))),
                                float(np.max(np.abs(entry.processed))))
                QtWidgets.QMessageBox.information(
                    self, "Combine Complete",
                    f"Combined signal added as {new}.")   # GUI.py:273
                self.status.setText(f"Status: Added combined signal {new} "
                                    f"(max amplitude: {amplitude:.2f})")
            except ValueError as e:
                if "Mixed sampling rates" in str(e):  # GUI.py:243-245
                    QtWidgets.QMessageBox.critical(
                        self, "Sampling Rate Mismatch",
                        "All selected signals must have the same "
                        "sampling rate.")
                else:
                    QtWidgets.QMessageBox.critical(self, "Combine error",
                                                   str(e))
            except Exception as e:
                QtWidgets.QMessageBox.critical(self, "Combine error", str(e))

        def _config(self):
            return SpecConfig.scipy_default(
                nperseg=self.spin_nperseg.value(),
                fmin=self.spin_fmin.value(), fmax=self.spin_fmax.value(),
                log_scale=self.chk_log.isChecked())

        def plot_selected(self):
            names = self._selected_names()
            if not names:
                QtWidgets.QMessageBox.warning(self, "Warning",
                                              "No sweep selected.")
                return
            # GUI-layer mixed-rate check with the reference's exact box
            # (GUI.py:415-418); the session re-checks and raises anyway
            rates = {self.session.registry.data[n].fs for n in names
                     if n in self.session.registry.data}
            if len(rates) > 1:
                QtWidgets.QMessageBox.critical(
                    self, "Error",
                    "Selected sweeps have different sampling rates and "
                    "cannot be plotted together.")
                return
            try:
                view = ViewSettings(
                    combine=self.chk_combine.isChecked(),
                    draw_raw=self.chk_raw.isChecked(),
                    draw_proc=self.chk_proc.isChecked(),
                    mode_raw=self.combo_raw.currentText(),
                    mode_proc=self.combo_proc.currentText())
                # editing suspended during replot (GUI.py:433-447);
                # restored in finally so a plot error cannot leave the
                # controller disarmed while the checkbox still shows checked
                was_editing = self.controller.roi_editor.editing
                self.controller.set_editing_enabled(False)
                try:
                    self.session.plot_sweeps(names, self._config(), view)
                finally:
                    self.controller.set_editing_enabled(was_editing)
                self._redraw()
                power = self.session.calculate_absolute_power()
                if power is None:   # no signal source (e.g. both RAW and
                    # PROC unchecked): plot_sweeps produced nothing
                    self.status.setText("Nothing to plot "
                                        "(no signal source selected)")
                else:
                    # the reference's exact status strings (GUI.py:440-453)
                    if view.combine:
                        text = f"Plotted concatenated {len(names)} sweeps."
                    else:
                        text = ("Plotted single sweep: "
                                f"{os.path.basename(names[0])}")
                    # the Total Power suffix appears only when this plot
                    # requested a spectrogram pane (the reference's
                    # source_candidate gate, PlotEngine.py:95-99 +
                    # GUI.py:450-453). Deliberate deviation: when no pane
                    # is requested the reference reports the PREVIOUS
                    # plot's power (clear(), :68-76, never resets
                    # last_Sxx); we report none (pinned by executing the
                    # reference: tests/test_reference_gui_differential.py
                    # ::test_signal_only_replot_stale_power_quirk)
                    spec_requested = (
                        (view.mode_proc in ("Spectrogram", "Both")
                         and self.session.signal_proc is not None)
                        or (view.mode_raw in ("Spectrogram", "Both")
                            and self.session.signal_raw is not None))
                    self._spec_plotted = spec_requested
                    if spec_requested:
                        text = f"{text} | Total Power: {power:.6f}"
                    self.status.setText(text)
            except Exception as e:
                QtWidgets.QMessageBox.critical(self, "Plot error", str(e))

        def _redraw(self):
            # the plotted data changed (plot/clear/reset): rebuild the
            # static layers into the SAME Figure object (no canvas swap, no
            # event re-wiring), then lay the current overlays back on top.
            # The draw recaptures the blit background via _on_draw.
            self.view.rebuild(self.session)
            ed = self.controller.roi_editor
            self.view.update_overlays(ed.patches(), ed.patch_colors(),
                                      ed.drag_span)
            self.canvas.draw()

        def detect(self):
            """GUI.py:455-476 — guard, progress, 0-event dialog and
            status strings are the reference's exact text."""
            if self.session.spec_data_source is None or \
                    not self._spec_plotted:
                QtWidgets.QMessageBox.warning(
                    self, "Action Required",
                    "Please plot a signal before running detection.")
                return
            self.status.setText("Status: Running HMM detection... "
                                "Please wait.")
            QtWidgets.QApplication.processEvents()
            try:
                events = self.session.unsupervised_detect()
                if not events:
                    QtWidgets.QMessageBox.information(
                        self, "Detection Result", "No events detected.")
                    self.status.setText("Status: HMM detected 0 events.")
                    return
                self._patches_changed()
                self.status.setText(
                    f"Status: HMM detected {len(events)} event(s).")
            except Exception as e:
                QtWidgets.QMessageBox.critical(
                    self, "HMM Error",
                    f"An error occurred during HMM detection:\n{e}")
                self.status.setText("Status: HMM detection failed.")

        def learn(self):
            """GUI.py:286-312 — the semi-supervised 'Learn from Examples'
            workflow with the reference's guards and status strings."""
            if self.session.spec_data_source is None or \
                    not self._spec_plotted:
                QtWidgets.QMessageBox.warning(
                    self, "Action Required",
                    "Please plot a signal before learning from it.")
                return
            if not self.controller.roi_editor.patches():
                QtWidgets.QMessageBox.warning(
                    self, "Action Required",
                    "Please enable manual editing and draw at least one "
                    "example region to learn from.")
                return
            self.status.setText("Status: Learning from examples and "
                                "detecting... Please wait.")
            QtWidgets.QApplication.processEvents()
            try:
                events = self.session.learn_and_detect(
                    self.controller.roi_editor.patches())
                if not events:
                    QtWidgets.QMessageBox.information(
                        self, "Detection Result",
                        "Could not detect any bursts after learning.")
                    self.status.setText("Status: Learning complete. "
                                        "No bursts found.")
                    return
                self._patches_changed()
                self.status.setText(f"Status: Learned from examples and "
                                    f"detected {len(events)} event(s).")
            except Exception as e:
                QtWidgets.QMessageBox.critical(
                    self, "Learning Error",
                    f"An error occurred during learning:\n{e}")
                self.status.setText("Status: Learning or detection failed.")

        def refine(self):
            """GUI.py:278-284: Refine Model warns when the plot carries no
            regions, then delegates to the learn workflow (so its progress
            and result strings are learn's)."""
            if not self.controller.roi_editor.patches():
                QtWidgets.QMessageBox.warning(
                    self, "Action Required",
                    "There are no burst regions on the plot to learn from. "
                    "Please perform an auto-detection and/or manually add "
                    "regions first.")
                return
            self.learn()

        def on_tree_item_clicked(self, item, column=0):
            """GUI.py:359-372: a click plots that single sweep — previous
            selection cleared, the clicked item selected, and 'Combine all
            sweeps' unchecked for clarity before delegating to
            plot_selected."""
            self.tree.clearSelection()
            item.setSelected(True)
            self.chk_combine.setChecked(False)
            self.plot_selected()

        def open_tree_context_menu(self, position):
            """GUI.py:485-494: Remove Selected / Select All / Clear All."""
            menu = QtWidgets.QMenu(self)
            for name in ("Remove Selected", "Select All", "Clear All"):
                menu.addAction(name)
            chosen = menu.exec_(QtGui.QCursor.pos())
            if chosen is None:
                return
            if chosen.text() == "Remove Selected":
                self.remove_selected()
            elif chosen.text() == "Select All":
                self.tree.selectAll()
            elif chosen.text() == "Clear All":
                self.clear_all()

        def remove_selected(self):
            """GUI.py:345-348: remove tree rows only (registry keeps the
            data, as the reference's manager.data does)."""
            for item in self.tree.selectedItems():
                self.tree.takeTopLevelItem(
                    self.tree.indexOfTopLevelItem(item))
            self.status.setText("Status: Removed selected items")

        def clear_all(self):
            """GUI.py:478-483: clear tree + plot state, disarm editing."""
            self.tree.clear()
            self.session.clear()
            self.chk_edit.setChecked(False)
            self._spec_plotted = False
            self._redraw()
            # the reference's clear_all leaves the status label untouched
            # (GUI.py:478-483)

        def reset_model(self):
            """GUI.py:350-357: reset the HMM and clear the canvas."""
            self.session.reset_model()
            self.session.clear()
            self._spec_plotted = False
            self._redraw()
            QtWidgets.QMessageBox.information(
                self, "Model Status",
                "The HMM model has been reset and the canvas has been "
                "cleared.")
            self.status.setText("Status: HMM model reset. Canvas cleared.")

        def band_powers(self):
            """Band-power dialog (GUI.py:529-566): no-spectrogram guard
            (:530-533), the log-scale refusal (:535-541), then a modal
            with selectable text — total power to 6 decimals on the first
            line, one bare '100*ratio:.2f' line per EEG band (:546-549),
            in a read-only QTextEdit titled 'Band Power Results'
            (:552-566)."""
            if self.session.last_sxx is None or not self._spec_plotted:
                QtWidgets.QMessageBox.warning(
                    self, "No Spectrogram",
                    "Please plot a signal with a spectrogram first.")
                return
            if self.chk_log.isChecked():
                QtWidgets.QMessageBox.warning(
                    self, "Band Power Disabled in Log Scale",
                    "Please disable log scale before calculating band "
                    "power.\n\nBand power must be calculated from the "
                    "original (linear) spectrum.")
                return
            band_ratios = self.session.calculate_band_powers()
            total_power = self.session.calculate_absolute_power()
            msg = f"{total_power:.6f}\n"
            for _band, ratio in band_ratios.items():
                msg += f"{100 * ratio:.2f}\n"

            dlg = QtWidgets.QDialog(self)
            dlg.setWindowTitle("Band Power Results")
            layout = QtWidgets.QVBoxLayout(dlg)
            text_box = QtWidgets.QTextEdit()
            text_box.setReadOnly(True)
            text_box.setText(msg)
            layout.addWidget(text_box)
            btn_close = QtWidgets.QPushButton("Close")
            btn_close.clicked.connect(dlg.accept)
            layout.addWidget(btn_close)
            dlg.resize(400, 300)
            dlg.exec_()

        def export_csv(self):
            """GUI.py:496-527 — plot-context and burst guards, the
            '{base}_bursts.csv' default filename, lastExportDir memory and
            the cancel status string."""
            if not self.session.currently_plotted_items:
                QtWidgets.QMessageBox.warning(
                    self, "No Plot Context",
                    "Please plot a signal first before exporting.")
                return
            if not self.controller.roi_editor.patches():
                QtWidgets.QMessageBox.warning(
                    self, "No Data",
                    "There are no detected bursts on the plot to export.")
                return
            first = self.session.currently_plotted_items[0]
            base = re.sub(r"_sweep\d+$", "", os.path.basename(first))
            last = self.settings.value(
                "lastExportDir", self.settings.value("lastDir", "", str),
                str)
            path, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, "Save Burst Data as CSV",
                os.path.join(last, f"{base}_bursts.csv"),
                "CSV Files (*.csv)")
            if not path:
                self.status.setText("Status: Export cancelled.")
                return
            self.settings.setValue("lastExportDir", os.path.dirname(path))
            self.status.setText(self.session.export_csv(path))

        def export_png(self):
            """GUI.py:568-575 — the plot-context guard; the cancel string
            is the exporter's return value (ExportManager.py:100-101)."""
            if not self.session.currently_plotted_items:
                QtWidgets.QMessageBox.warning(
                    self, "No Plot Context",
                    "Please plot a signal first before exporting.")
                return
            last = self.settings.value("lastExportDir", "", str)
            path, _ = QtWidgets.QFileDialog.getSaveFileName(
                self, "Save Figure as Transparent PNG", last,
                "PNG Files (*.png)")
            if not path:
                self.status.setText("Export cancelled.")
                return
            self.settings.setValue("lastExportDir", os.path.dirname(path))
            self.status.setText(self.session.export_png(path))

        def export_batch(self):
            """Batch PNG export of the selected signals (GUI.py:577-586;
            the no-selection warning is :579-581, the cancel string is the
            exporter's return value, ExportManager.py:120-121)."""
            if not self.tree.selectedItems():
                QtWidgets.QMessageBox.warning(
                    self, "No Selection",
                    "Please select one or more items to export.")
                return
            last = self.settings.value("lastExportDir", "", str)
            out_dir = QtWidgets.QFileDialog.getExistingDirectory(
                self, "Select Folder to Save PNGs", last)
            if not out_dir:
                self.status.setText("Export cancelled.")
                return
            self.settings.setValue("lastExportDir", out_dir)
            try:
                msg = self.controller.export_batch(
                    out_dir, self._selected_names(),
                    use_proc=self.chk_proc.isChecked(),
                    use_raw=self.chk_raw.isChecked())
                self.status.setText(msg)
            except Exception as e:
                QtWidgets.QMessageBox.critical(self, "Batch export", str(e))

    return MainWindow()


def main(argv=None, device="cuda") -> int:
    """Run the window over a session on ``device`` (the card unless 'cpu'
    is named); 2 without PyQt5."""
    if not _require_qt():
        sys.stderr.write(
            "spectral-tpu gui requires PyQt5 (optional dependency; "
            "pip install PyQt5). The headless CLI covers every operation: "
            "spectral-tpu --help\n")
        return 2
    from PyQt5 import QtWidgets
    app = QtWidgets.QApplication(argv or sys.argv)
    win = build_window(device=device)
    win.resize(1200, 800)
    win.show()
    return app.exec_()


if __name__ == "__main__":
    sys.exit(main())
