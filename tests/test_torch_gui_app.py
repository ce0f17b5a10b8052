"""The port's Qt window (spectral_tpu_torch.gui.app, device='cpu') held
against the JAX package's (spectral_tpu.gui.app) under tests/qt_stub.py.

Each case builds both windows over the same seeded sweeps, drives them
through one script of tests/test_gui_app.py's actions (settings
round-trip, plot, detect, learn, refine, ROI draw/delete/merge, band
powers, combine, CSV/PNG/batch export, the tree's menu, the guards) and
records after every action the status text, the message-box calls, the
QSettings store, the tree's items, the events, the ROIs and the files
written. The two records must be equal, with one exception: the numbers
that print the PSD's sums (the plot's "Total Power", the band-power
dialog) are parsed and held to PSD_REL (the JAX package sums its float32
transforms, the port its float64 ones; tests/test_torch_session.py's
tolerance on the PSD itself). Everything else, CSV and PNG bytes
included, must be equal exactly.
"""

import importlib
import os
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

import qt_stub  # noqa: E402

FS = 1000.0
PSD_REL = 5e-6          # the PSD's sums, relative
PERCENT_ABS = 0.01 + 1e-9   # a band's percentage, printed to 2 decimals
_NUMBER = re.compile(r"-?\d+\.\d+(?:e[+-]?\d+)?")


def _sweeps():
    rng = np.random.RandomState(0)
    n = int(FS * 60)
    t = np.arange(n) / FS
    x = 0.05 * rng.randn(n).astype(np.float32)
    for a, b in ((10.0, 15.0), (30.0, 38.0)):
        m = (t >= a) & (t < b)
        x[m] += np.sin(2 * np.pi * 6.0 * t[m]).astype(np.float32)
    return x


def _window(pkg):
    """The package's MainWindow under the stub, with tests/test_gui_app.py's
    two synthetic sweeps registered and the first selected."""
    qt_stub.install()
    sys.modules.pop(f"{pkg}.gui.app", None)
    app = importlib.import_module(f"{pkg}.gui.app")
    registry = importlib.import_module(f"{pkg}.io.registry")
    qt_stub.QSettings._stores.clear()
    qt_stub.QMessageBox.calls.clear()
    qt_stub.QDialog.shown.clear()
    qt_stub.QFileDialog.calls.clear()
    qt_stub.QMenu.next_choice = None
    w = (app.build_window(device="cpu") if pkg == "spectral_tpu_torch"
         else app.build_window())
    x = _sweeps()
    for i, raw in enumerate((x, x[:len(x) // 2])):
        w.session.registry.register(f"s_sweep{i}", registry.SweepEntry(
            filepath="<synth>", sweep_idx=i, fs=FS, fs_raw=FS, raw=raw,
            processed=None))
        w._add_tree_item(f"s_sweep{i}")
    w.tree.topLevelItem(0).setSelected(True)
    return w


def _snapshot(w, label):
    """What a user and the files can see after an action."""
    tree = [(w.tree.topLevelItem(i).data(0, 256),
             w.tree.topLevelItem(i)._selected)
            for i in range(w.tree.topLevelItemCount())]
    store = qt_stub.QSettings._stores.get(
        ("spectral_tpu", "SpectrogramGenerator"), {})
    dialogs = [dlg._layout.items[0].toPlainText()
               for dlg in qt_stub.QDialog.shown
               if dlg._title == "Band Power Results"]
    return {"action": label, "status": w.status.text(),
            "boxes": list(qt_stub.QMessageBox.calls),
            "settings": dict(store), "tree": tree,
            "events": list(w.session.last_detected_events),
            "rois": list(w.session.rois),
            "refined": w.session.detector.is_model_refined,
            "learn_enabled": w.btn_learn.isEnabled(),
            "band_dialogs": dialogs,
            "file_dialogs": list(qt_stub.QFileDialog.calls)}


def _plot(w, nperseg=512):
    w.chk_raw.setChecked(True)
    w.chk_proc.setChecked(False)
    w.combo_raw.setCurrentText("Both")
    w.spin_nperseg.setValue(nperseg)
    w.spin_fmin.setValue(0.0)
    w.spin_fmax.setValue(30.0)
    w.plot_selected()


def _drag(w, a, b):
    w.canvas.handlers["button_press_event"](qt_stub._Event(a, 1))
    w.canvas.handlers["motion_notify_event"](qt_stub._Event(
        0.5 * (a + b), 1))
    w.canvas.handlers["button_release_event"](qt_stub._Event(b, 1))


def _right_click(w, x, choice):
    qt_stub.QMenu.next_choice = choice
    try:
        w.canvas.handlers["button_press_event"](qt_stub._Event(x, 3))
    finally:
        qt_stub.QMenu.next_choice = None


def _tree_menu(w, choice):
    qt_stub.QMenu.next_choice = choice
    try:
        w.tree.customContextMenuRequested.emit(qt_stub.QPoint())
    finally:
        qt_stub.QMenu.next_choice = None


def _settings(w, out):
    w.spin_nperseg.setValue(2048)
    w.chk_log.setChecked(True)
    w.combo_proc.setCurrentText("Spectrogram")
    w.spin_fmin.setValue(1.5)
    w.spin_fmax.setValue(45.0)
    w.chk_combine.setChecked(True)
    w.chk_raw.setChecked(False)
    w.chk_proc.setChecked(True)
    return [_snapshot(w, "settings")]


def _plot_detect(w, out):
    _plot(w)
    rec = [_snapshot(w, "plot")]
    w.detect()
    rec.append(_snapshot(w, "detect"))
    w.reset_model()
    rec.append(_snapshot(w, "reset"))
    return rec


def _roi_edit(w, out):
    _plot(w)
    rec = [_snapshot(w, "plot")]
    w.chk_edit.setChecked(True)
    rec.append(_snapshot(w, "edit on"))
    w.learn()                              # no patches yet: a warning
    rec.append(_snapshot(w, "learn without patches"))
    _drag(w, 9.0, 16.0)
    rec.append(_snapshot(w, "draw"))
    _drag(w, 29.0, 39.0)
    _right_click(w, 30.0, "Delete")
    rec.append(_snapshot(w, "delete"))
    _drag(w, 5.0, 20.0)
    _right_click(w, 6.0, "Merge")
    rec.append(_snapshot(w, "merge"))
    w.chk_edit.setChecked(False)
    rec.append(_snapshot(w, "edit off"))
    return rec


def _learn_refine(w, out):
    _plot(w)
    w.chk_edit.setChecked(True)
    _drag(w, 9.0, 16.0)
    _drag(w, 29.0, 39.0)
    w.learn()
    rec = [_snapshot(w, "learn")]
    w.refine()
    rec.append(_snapshot(w, "refine"))
    return rec


def _band_powers(w, out):
    w.band_powers()                        # no plot yet
    rec = [_snapshot(w, "bands without plot")]
    _plot(w)
    w.chk_log.setChecked(True)
    w.band_powers()                        # refused in log scale
    rec.append(_snapshot(w, "bands in log scale"))
    w.chk_log.setChecked(False)
    w.band_powers()
    rec.append(_snapshot(w, "bands"))
    return rec


def _combine(w, out):
    w.tree.topLevelItem(1).setSelected(True)
    w.chk_proc.setChecked(False)
    w.register_combined()
    rec = [_snapshot(w, "combine")]
    w.on_tree_item_clicked(w.tree.topLevelItem(2), 0)
    rec.append(_snapshot(w, "click combined"))
    return rec


def _exports(w, out):
    _plot(w)
    w.detect()
    rec = [_snapshot(w, "detect")]
    qt_stub.QFileDialog.next_save_file = os.path.join(out, "bursts.csv")
    w.export_csv()
    rec.append(_snapshot(w, "csv"))
    qt_stub.QFileDialog.next_save_file = os.path.join(out, "fig.png")
    w.export_png()
    rec.append(_snapshot(w, "png"))
    batch = os.path.join(out, "batch")
    os.makedirs(batch)
    qt_stub.QFileDialog.next_directory = batch
    w.export_batch()
    rec.append(_snapshot(w, "batch"))
    qt_stub.QFileDialog.next_save_file = ""
    w.export_csv()
    rec.append(_snapshot(w, "csv cancelled"))
    return rec


def _guards_and_menu(w, out):
    w.detect()
    rec = [_snapshot(w, "detect before plot")]
    for i in range(w.tree.topLevelItemCount()):
        w.tree.topLevelItem(i).setSelected(False)
    for action in (w.plot_selected, w.export_csv, w.export_png,
                   w.export_batch):
        action()
        rec.append(_snapshot(w, action.__name__))
    _tree_menu(w, "Select All")
    rec.append(_snapshot(w, "select all"))
    _plot(w)
    w.chk_edit.setChecked(True)
    w.session.add_roi(9.0, 12.0)
    _tree_menu(w, "Clear All")
    rec.append(_snapshot(w, "clear all"))
    return rec


def _add_files(w, out):
    from spectral_tpu_torch.io.wav import write_wav
    path = os.path.join(out, "extra.wav")
    write_wav(path, np.sin(np.linspace(0, 50, 4000)) * 0.4, FS)
    qt_stub.QFileDialog.next_open_files = [path]
    w.add_files()
    rec = [_snapshot(w, "add files")]
    qt_stub.QFileDialog.next_open_files = [os.path.join(out, "nope.wav")]
    w.add_files()
    rec.append(_snapshot(w, "add a missing file"))
    w.remove_selected()
    rec.append(_snapshot(w, "remove selected"))
    return rec


def _random_walk(w, out):
    """tests/test_gui_app.py's seeded walk, shorter: the same actions in
    the same order on both windows."""
    rng = np.random.RandomState(11)
    w.chk_raw.setChecked(True)
    w.combo_raw.setCurrentText("Both")
    w.spin_nperseg.setValue(256)
    rec = []
    for step in range(24):
        act = rng.choice(["plot", "tree_click", "toggle_edit", "draw",
                          "delete", "merge", "detect", "reset", "clear",
                          "bands", "settings"])
        if act == "plot":
            w.plot_selected()
        elif act == "tree_click" and w.tree.topLevelItemCount():
            w.on_tree_item_clicked(w.tree.topLevelItem(
                int(rng.randint(w.tree.topLevelItemCount()))), 0)
        elif act == "toggle_edit":
            w.chk_edit.setChecked(not w.chk_edit.isChecked())
        elif act == "draw":
            a = float(rng.uniform(0, 50))
            _drag(w, a, a + float(rng.uniform(1, 8)))
        elif act in ("delete", "merge"):
            _right_click(w, float(rng.uniform(0, 60)), act.capitalize())
        elif act == "detect":
            w.detect()
        elif act == "reset":
            w.reset_model()
        elif act == "clear":
            w.session.clear()
        elif act == "bands":
            w.band_powers()
        else:
            w.spin_nperseg.setValue(int(rng.choice([128, 256, 512])))
        rec.append(_snapshot(w, f"{step} {act}"))
    return rec


SCRIPTS = {"settings": _settings, "plot_detect": _plot_detect,
           "roi_edit": _roi_edit, "learn_refine": _learn_refine,
           "band_powers": _band_powers, "combine": _combine,
           "exports": _exports, "guards_and_menu": _guards_and_menu,
           "add_files": _add_files, "random_walk": _random_walk}


def _run(pkg, script, tmp_path):
    """The script on pkg's window in tmp_path/'run' (the same path for both
    packages, so the texts that name it agree), then the directory's files
    by relative path."""
    out = tmp_path / "run"
    out.mkdir()
    try:
        w = _window(pkg)
        record = SCRIPTS[script](w, str(out))
    finally:
        qt_stub.uninstall()
        sys.modules.pop(f"{pkg}.gui.app", None)
    files = {}
    for root, _, names in os.walk(out):
        for name in names:
            p = os.path.join(root, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, out)] = fh.read()
    shutil.move(str(out), str(tmp_path / pkg))
    return record, files


def _numbers(text):
    return [float(v) for v in _NUMBER.findall(text)]


def _same_sums(got, want, what):
    """Texts equal but for the PSD sums they print: the numbers held to
    PSD_REL (totals) or PERCENT_ABS (percentages, the band dialog's
    lines after the first)."""
    assert _NUMBER.sub("#", got) == _NUMBER.sub("#", want), what
    g, w = _numbers(got), _numbers(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        if "Band" in what and i > 0:
            assert abs(a - b) <= PERCENT_ABS, (what, a, b)
        else:
            assert abs(a - b) <= PSD_REL * max(abs(b), 1e-30), (what, a, b)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_window_gives_the_jax_windows_record(script, tmp_path):
    want, want_files = _run("spectral_tpu", script, tmp_path)
    got, got_files = _run("spectral_tpu_torch", script, tmp_path)
    assert EXPECT[script](want, want_files), f"{script}: the script did " \
        "not reach what it drives"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        what = f"{script}: {w['action']}"
        _same_sums(g.pop("status"), w.pop("status"), what + " status")
        gd, wd = g.pop("band_dialogs"), w.pop("band_dialogs")
        assert len(gd) == len(wd), what
        for a, b in zip(gd, wd):
            _same_sums(a, b, what + " Band dialog")
        assert g == w, what
    assert sorted(got_files) == sorted(want_files)
    for name in want_files:
        assert got_files[name] == want_files[name], name


# what each script must reach on the JAX window, so that an equal record
# cannot be an empty one
EXPECT = {
    "settings": lambda r, f: r[0]["settings"]["nperseg"] == 2048,
    "plot_detect": lambda r, f: ("Total Power" in r[0]["status"]
                                 and len(r[1]["events"]) >= 2
                                 and r[2]["events"] == []),
    "roi_edit": lambda r, f: (r[3]["rois"] == [(9.0, 16.0)]
                              and r[5]["events"] == [(9.0, 16.0)]
                              and r[2]["boxes"][-1][0] == "warning"),
    "learn_refine": lambda r, f: r[0]["refined"] and "Learned" in r[1][
        "status"],
    "band_powers": lambda r, f: (r[0]["boxes"][-1][1] == "No Spectrogram"
                                 and len(r[2]["band_dialogs"]) == 1),
    "combine": lambda r, f: "combine0" in [n for n, _ in r[0]["tree"]],
    "exports": lambda r, f: {"bursts.csv", "fig.png", os.path.join(
        "batch", "s_sweep0.png")} <= set(f) and len(r[0]["events"]) >= 2,
    "guards_and_menu": lambda r, f: (len(r[0]["boxes"]) == 1
                                     and r[-1]["tree"] == []),
    "add_files": lambda r, f: (r[0]["status"] == "Status: Loaded extra.wav"
                               and r[1]["boxes"][-1][1] == "Load Error"),
    "random_walk": lambda r, f: (
        any("Plotted" in s["status"] for s in r)
        and len({s["status"] for s in r}) >= 4),
}


def test_port_window_takes_the_card_by_default():
    """build_window() gives the session device='cuda'; device='cpu' is the
    caller's to ask for."""
    qt_stub.install()
    try:
        sys.modules.pop("spectral_tpu_torch.gui.app", None)
        app = importlib.import_module("spectral_tpu_torch.gui.app")
        import inspect
        assert inspect.signature(app.build_window).parameters[
            "device"].default == "cuda"
        assert app.build_window().session.device == "cuda"
        assert app.build_window(device="cpu").session.device == "cpu"
    finally:
        qt_stub.uninstall()
        sys.modules.pop("spectral_tpu_torch.gui.app", None)


def test_main_without_pyqt5_says_what_the_jax_window_says(capsys,
                                                          monkeypatch):
    from spectral_tpu.gui import app as japp
    from spectral_tpu_torch.gui import app as tapp
    monkeypatch.setitem(sys.modules, "PyQt5", None)
    assert tapp.main([]) == japp.main([]) == 2
    err = capsys.readouterr().err
    half = len(err) // 2
    assert err[:half] == err[half:] and "PyQt5" in err


def test_chip_smokes_gui_phase_runs_here_on_the_stub():
    """chip_smoke.py's GUI phase, rehearsed on the CPU: the branch a host
    with matplotlib and no PyQt5 takes."""
    import chip_smoke
    chip_smoke.gui_phase(torch.device("cpu"))
    assert "PyQt5" not in sys.modules
    assert "spectral_tpu_torch.gui.app" not in sys.modules
