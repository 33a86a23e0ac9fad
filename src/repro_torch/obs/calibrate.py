"""LBCP cost-model calibration: fit effective HardwareProfile rates to
measured per-(stage, tick) spans (the port's own copy of
``repro.obs.calibrate``).

The analytic chunk cost is LINEAR in four effective inverse rates
(``costmodel.FEATURE_TERMS``): within the attention regime the nominal
profile picks, ``X @ theta == dur + comm + spill_t + fetch_t`` holds exactly
for the work-quantity matrix ``X = chunk_cost_features(...)`` and
``theta = profile_theta(hw, tp)``. Calibration inverts that identity:

    theta* = argmin_theta || X @ theta - measured ||_2

over one design row per VALID (stage, tick) of a ``MeasuredProfile`` (the
positions where ``0 <= phase < M`` — the same index alignment as the device
``TelemetryProfile``). Columns with no signal in the run (e.g. no
bandwidth-bound chunk) and non-positive fitted rates (unidentifiable under
noise) keep their NOMINAL rate — the fit only moves terms the data pins
down. ``profile_from_theta`` folds theta* back into a ``HardwareProfile``
whose effective fields absorb the fit, so ``lbcp.plan_partition``,
``chunk_cost_arrays`` and the scheduler admission costs consume it with no
call-site changes.

Persistence: ``save_profile`` writes ``{"profile": ..., "fit": ...}`` JSON
via the atomic writer. json floats round-trip bit-identically (repr =
shortest round-trip), so a loaded profile reproduces the exact
``dp_partition`` output of the in-memory one (asserted in
the tests). The ``fit`` block carries the per-(chunk, stage)
residuals (the reference's dryrun records them next to ``wire_model``).

What a fit means on the port: one tick runs all N stages batched on ONE
card, the fill/drain bubble included, so a measured tick span is N stages'
work on one card, not one stage's work on its own device, which is what
the cost model prices. The math is the reference's, unchanged, so a
profile fitted to such spans is an effective "N stages on one card"
profile; its callers (``launch.serve --calibrate``, ``chip_smoke.py``)
record ``num_stages`` and ``one_card: true`` in the saved ``meta`` and do
not rescale the rates.

Import-light: numpy + costmodel only (usable from the scheduler path).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.obs._io import atomic_write_text


def mape(pred, true) -> float:
    """Mean absolute percentage error over the entries with nonzero truth
    (zero-truth rows carry no scale information); 0.0 on an empty mask."""
    pred = np.asarray(pred, float).ravel()
    true = np.asarray(true, float).ravel()
    mask = true > 0
    if not mask.any():
        return 0.0
    return float(np.mean(np.abs(pred[mask] - true[mask]) / true[mask]))


@dataclass
class FitResult:
    """One calibration fit: the profile + everything needed to audit it."""
    profile: cm.HardwareProfile      # calibrated (effective rates absorbed)
    nominal: cm.HardwareProfile
    theta: np.ndarray                # fitted inverse rates [4], FEATURE_TERMS
    theta_nominal: np.ndarray
    rows: List[Tuple[int, int]]      # (chunk, stage) of each design row
    residual_s: np.ndarray           # measured - calibrated prediction, [rows]
    mape_nominal: float              # nominal prediction vs measured
    mape_calibrated: float           # calibrated prediction vs measured

    def residual_records(self) -> List[Dict]:
        """Per-(chunk, stage) residual rows for the dryrun record."""
        return [{"chunk": int(c), "stage": int(s), "residual_s": float(r)}
                for (c, s), r in zip(self.rows, self.residual_s)]


def design_matrix(sm: cm.StageModel, chunks: Sequence[int],
                  hw: cm.ProfileSpec, tick_s: np.ndarray, *,
                  mbkr_plan=None, compress: float = 1.0
                  ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int]]]:
    """``(X, y, rows)``: one row per valid (stage, tick) of the ``[N, T]``
    span array — phase ``t - s`` in ``[0, M)`` maps that span to chunk
    ``phase``'s feature row. Fill/drain ticks (garbage compute) are NOT
    design rows."""
    feats = cm.chunk_cost_features(sm, chunks, hw, mbkr_plan=mbkr_plan,
                                   compress=compress)
    tick_s = np.asarray(tick_s, float)
    n, t_all = tick_s.shape
    m = len(chunks)
    xs, ys, rows = [], [], []
    for s in range(n):
        for t in range(t_all):
            ph = t - s
            if 0 <= ph < m:
                xs.append(feats[ph])
                ys.append(tick_s[s, t])
                rows.append((ph, s))
    return np.asarray(xs), np.asarray(ys), rows


def fit_profile(sm: cm.StageModel, chunks: Sequence[int], measured,
                hw: cm.ProfileSpec, *, mbkr_plan=None, compress: float = 1.0,
                name: Optional[str] = None) -> FitResult:
    """Least-squares fit of the effective rates against measured spans.

    ``measured``: an ``obs.profile.MeasuredProfile`` or a raw ``[N, T]``
    seconds array aligned like the telemetry profiles (stage-major,
    ``T = M + N - 1``).
    """
    hw = cm.resolve_profile(hw)
    tick_s = getattr(measured, "tick_s", measured)
    x, y, rows = design_matrix(sm, chunks, hw, tick_s,
                               mbkr_plan=mbkr_plan, compress=compress)
    theta0 = cm.profile_theta(hw, sm.tp)
    theta = theta0.copy()
    active = np.abs(x).sum(axis=0) > 0 if len(y) else np.zeros(4, bool)
    if active.any():
        sol, *_ = np.linalg.lstsq(x[:, active], y, rcond=None)
        for j, v in zip(np.flatnonzero(active), sol):
            if v > 0:           # a non-positive rate is unidentifiable noise
                theta[j] = float(v)
    prof = cm.profile_from_theta(hw, theta, sm.tp, name=name)
    pred_cal, pred_nom = x @ theta, x @ theta0
    return FitResult(profile=prof, nominal=hw, theta=theta,
                     theta_nominal=theta0, rows=rows,
                     residual_s=y - pred_cal,
                     mape_nominal=mape(pred_nom, y),
                     mape_calibrated=mape(pred_cal, y))


# ---------------------------------------------------------------- persistence

def save_profile(path: str, profile: cm.HardwareProfile, *,
                 fit: Optional[FitResult] = None,
                 meta: Optional[Dict] = None) -> str:
    """Atomically write a calibrated-profile JSON: ``{"profile": {...}}``
    plus, when a fit is given, the full audit block (nominal profile, theta
    pair, MAPEs, per-(chunk, stage) residuals)."""
    blob: Dict = {"profile": cm.profile_to_dict(profile)}
    if fit is not None:
        blob["fit"] = {
            "feature_terms": list(cm.FEATURE_TERMS),
            "nominal": cm.profile_to_dict(fit.nominal),
            "theta": [float(v) for v in fit.theta],
            "theta_nominal": [float(v) for v in fit.theta_nominal],
            "mape_nominal": fit.mape_nominal,
            "mape_calibrated": fit.mape_calibrated,
            "residuals": fit.residual_records(),
        }
    if meta:
        blob["meta"] = dict(meta)
    return atomic_write_text(path, json.dumps(blob, indent=1))


def load_profile(path: str) -> Tuple[cm.HardwareProfile, Dict]:
    """``(profile, blob)`` — the profile plus the raw JSON (fit metadata)."""
    with open(path) as f:
        blob = json.load(f)
    return cm.profile_from_dict(blob.get("profile", blob)), blob


# ------------------------------------------------------------ dryrun record

def calibration_record(sm: cm.StageModel, chunks: Sequence[int],
                       hw_nominal: cm.ProfileSpec, calibrated_path: str, *,
                       mbkr_plan=None, compress: float = 1.0) -> Dict:
    """Dryrun's ``calibration`` block (recorded next to ``wire_model`` /
    ``occupancy_model``): per-chunk predicted costs under the nominal and
    calibrated profiles for THIS cell's plan, plus the persisted fit
    residuals — so a cell artifact says how far the measured hardware moved
    the partitioning inputs."""
    hw_nominal = cm.resolve_profile(hw_nominal)
    cal, blob = load_profile(calibrated_path)

    def total(hw):
        dur, comm, _, spill_t, fetch_t = cm.chunk_cost_arrays(
            sm, chunks, hw, mbkr_plan=mbkr_plan, compress=compress)
        return dur + comm + spill_t + fetch_t

    t_nom, t_cal = total(hw_nominal), total(cal)
    fit = blob.get("fit", {})
    return {
        "profile": cal.name,
        "nominal_profile": hw_nominal.name,
        "chunk_cost_nominal_s": [float(v) for v in t_nom],
        "chunk_cost_calibrated_s": [float(v) for v in t_cal],
        "shift_frac": mape(t_nom, t_cal),
        "mape_nominal": fit.get("mape_nominal"),
        "mape_calibrated": fit.get("mape_calibrated"),
        "residuals": fit.get("residuals", []),
    }
