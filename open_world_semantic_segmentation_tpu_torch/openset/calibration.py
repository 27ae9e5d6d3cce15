"""GMM/ECDF per-class score calibration — the reference's dormant design,
made a working opt-in feature. A numpy copy of the JAX package's
``openset/calibration.py`` (the port imports nothing of that package), so
the same ``np.random.Generator`` draws give the same samples and fits.

The reference ships this machinery only as commented-out scaffolding in
``DeepLabV3Plus-Pytorch/main_embedding.py:175-226`` (collection + fit) with
the ``Normalization``/``Certainty`` helpers at ``main_embedding.py:101-113``
(the only live lines of the design).  Semantics reproduced here:

* **Collect** (main_embedding.py:175-196): over a validation pass, build one
  sample list per known class ``cl`` from the per-pixel ``dis_sum`` map
  (``-sum_k logits_k``, i.e. the summed squared distances of the DML head)
  restricted to pixels where prediction AND ground truth agree on ``cl``,
  random-subsampled at rate 1/500; plus one list for the unknown region
  (``label == 255``) additionally filtered to ``dis_sum < 1000``.
* **Fit** (main_embedding.py:198-219): per class, a 2-component 1-D Gaussian
  mixture (the sharp component models confidently-known pixels) and an
  empirical CDF of the samples; a per-class threshold
  ``mean[argmin(cov)] - sqrt(min(cov))`` is recorded.
* **Certainty** (main_embedding.py:106-113): ``c = ECDF_cl(dis_sum)`` with
  ``c[c > 0.15] = 1`` (the active line); the commented alternative is a
  sigmoid ramp ``1 / (1 + exp(-50 * (c - ECDF_cl(thre))))`` — both are
  implemented here behind ``mode=\"step\"|\"sigmoid\"``.
* **Apply** (main_embedding.py:249-258): the calibrated certainty map is the
  softmax-probability-weighted mixture of per-class certainties evaluated on
  the dis_sum map clipped at 1000; the anomaly confidence is its complement.

The GMM fit is a native, deterministic 1-D EM (no sklearn dependency at
runtime; sklearn's ``GaussianMixture`` is used as the test oracle) and the
ECDF is the standard right-continuous ``P(X <= x)`` step function
(statsmodels' definition, which this environment does not ship).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fit_gmm2_1d",
    "ecdf_eval",
    "certainty",
    "collect_dissum_samples",
    "ScoreCalibration",
]


def fit_gmm2_1d(x, n_iter: int = 200, tol: float = 1e-8):
    """Deterministic 2-component 1-D Gaussian-mixture EM.

    Init: means at the 25th/75th percentiles, shared variance, equal
    weights — deterministic, so repeated fits agree bit-for-bit (the
    reference pins ``random_state=0`` on sklearn for the same reason,
    main_embedding.py:207).  Returns ``(means, variances, weights)`` each
    of shape (2,), components in fit order.
    """
    x = np.asarray(x, np.float64).ravel()
    if x.size < 2:
        raise ValueError("need at least 2 samples to fit a 2-component GMM")
    mu = np.percentile(x, [25.0, 75.0])
    if mu[0] == mu[1]:  # degenerate spread: nudge apart by the data scale
        span = max(float(x.std()), 1e-6)
        mu = np.array([mu[0] - span, mu[1] + span])
    var = np.full(2, max(float(x.var()), 1e-12))
    w = np.array([0.5, 0.5])
    ll_prev = -np.inf
    for _ in range(n_iter):
        # E step: responsibilities under each Gaussian (log-domain)
        log_p = (-0.5 * (x[None, :] - mu[:, None]) ** 2 / var[:, None]
                 - 0.5 * np.log(2 * np.pi * var[:, None])
                 + np.log(w[:, None]))
        m = log_p.max(axis=0)
        log_norm = m + np.log(np.exp(log_p - m).sum(axis=0))
        resp = np.exp(log_p - log_norm)
        ll = float(log_norm.mean())
        # M step
        nk = resp.sum(axis=1) + 1e-12
        mu = (resp @ x) / nk
        var = (resp @ x ** 2) / nk - mu ** 2
        var = np.maximum(var, 1e-12)
        w = nk / x.size
        if ll - ll_prev < tol:
            break
        ll_prev = ll
    return mu, var, w


def ecdf_eval(sorted_samples, q):
    """Right-continuous empirical CDF: ``P(X <= q)`` over the fit samples.

    ``sorted_samples`` must be ascending (as stored by ScoreCalibration).
    Matches statsmodels' ``ECDF`` evaluated pointwise.
    """
    sorted_samples = np.asarray(sorted_samples)
    q = np.asarray(q)
    n = sorted_samples.size
    return np.searchsorted(sorted_samples, q, side="right") / float(n)


def certainty(x, sorted_samples, thre=None, mode: str = "step",
              step_cut: float = 0.15, coefficient: float = 50.0):
    """Per-class certainty of the dis_sum value ``x``.

    ``step`` (the reference's active line, main_embedding.py:106-109):
    ECDF value with everything above ``step_cut`` saturated to 1.
    ``sigmoid`` (the commented alternative, :110-112): a sharp sigmoid ramp
    of the ECDF value around ``ECDF(thre)``.
    """
    c = ecdf_eval(sorted_samples, x)
    if mode == "step":
        return np.where(c > step_cut, 1.0, c)
    if mode == "sigmoid":
        if thre is None:
            raise ValueError("sigmoid mode needs the per-class threshold")
        t = ecdf_eval(sorted_samples, thre)
        return 1.0 / (1.0 + np.exp(-coefficient * (c - t)))
    raise ValueError(f"unknown certainty mode {mode!r}")


def collect_dissum_samples(dissum, preds, labels, num_classes: int,
                           data_list, rng, rate: int = 500,
                           unknown_cap: float = 1000.0):
    """Accumulate one image's per-class dis_sum samples into ``data_list``.

    ``data_list`` has ``num_classes + 1`` lists (last = unknown).  Per class:
    pixels where prediction and label agree, subsampled ``n//rate`` with
    replacement (reference uses ``np.random.choice`` defaults,
    main_embedding.py:190); unknown: ``label == 255`` pixels, subsampled,
    then filtered to ``< unknown_cap`` (:193-195).
    """
    feat = np.asarray(dissum).ravel()
    prd = np.asarray(preds).ravel()
    tru = np.asarray(labels).ravel()
    for cl in range(num_classes):
        mask = (tru == cl) & (prd == cl)
        if np.any(mask):
            vals = feat[mask]
            take = int(len(vals) / rate)
            if take:
                data_list[cl] += rng.choice(vals, take).tolist()
    unk = feat[tru == 255]
    if unk.size:
        take = int(len(unk) / rate)
        if take:
            picked = rng.choice(unk, take)
            data_list[-1] += picked[picked < unknown_cap].tolist()
    return data_list


class ScoreCalibration:
    """Fitted per-class calibration state (ECDF samples + GMM threshold)."""

    def __init__(self, sorted_samples, thresholds, gmm_params,
                 mode: str = "step", clip: float = 1000.0):
        self.sorted_samples = sorted_samples  # list of ascending arrays
        self.thresholds = thresholds          # (C,) per-class thre
        self.gmm_params = gmm_params          # list of (mu, var, w)
        self.mode = mode
        self.clip = clip

    @property
    def num_classes(self) -> int:
        return len(self.sorted_samples)

    @classmethod
    def fit(cls, data_list, mode: str = "step", clip: float = 1000.0,
            min_samples: int = 2, has_unknown: bool = True):
        """Fit from per-class sample lists.

        ``has_unknown=True`` (the layout ``collect_dissum_samples``
        produces): ``data_list`` is ``num_classes + 1`` lists and the
        trailing unknown list is not calibrated — the reference fits only
        known classes (main_embedding.py:203-219). Pass
        ``has_unknown=False`` when every list is a known class; the slot
        is declared explicitly rather than guessed from the list length.
        """
        if has_unknown:
            if len(data_list) < 2:
                raise ValueError(
                    "has_unknown=True needs num_classes+1 sample lists "
                    f"(got {len(data_list)}); pass has_unknown=False if "
                    "there is no trailing unknown slot")
            known = data_list[:-1]
        else:
            known = data_list
        sorted_samples, thresholds, gmm_params = [], [], []
        n_null = 0
        for cl, samples in enumerate(known):
            s = np.sort(np.asarray(samples, np.float64).ravel())
            if s.size < min_samples:
                # no pixels where prediction and label agreed on this class
                # (the reference's np.any guard, main_embedding.py:188, just
                # skips collection — a null calibration keeps the class's
                # certainty at 1, i.e. it contributes uncalibrated)
                sorted_samples.append(np.empty(0, np.float64))
                thresholds.append(0.0)
                gmm_params.append((np.zeros(2), np.ones(2),
                                   np.full(2, 0.5)))
                n_null += 1
                continue
            mu, var, w = fit_gmm2_1d(s)
            k = int(np.argmin(var))
            thre = float(mu[k] - np.sqrt(var[k]))  # main_embedding.py:215-217
            sorted_samples.append(s)
            thresholds.append(thre)
            gmm_params.append((mu, var, w))
        if n_null:
            print(f"score calibration: {n_null}/{len(known)} classes had "
                  "too few agreeing pixels — left uncalibrated "
                  "(certainty 1)")
        if n_null == len(known):
            raise ValueError("no class produced calibration samples — "
                             "collect more images")
        return cls(sorted_samples, np.asarray(thresholds), gmm_params,
                   mode=mode, clip=clip)

    def certainty_map(self, dissum, cl: int):
        x = np.minimum(np.asarray(dissum, np.float64), self.clip)
        if self.sorted_samples[cl].size == 0:  # null-calibrated class
            return np.ones_like(x)
        return certainty(x, self.sorted_samples[cl], self.thresholds[cl],
                         mode=self.mode)

    def apply(self, probs, dissum):
        """Calibrated certainty map (main_embedding.py:249-253).

        ``probs``: softmax probabilities, shape (..., C) with
        C == num_classes; ``dissum``: matching spatial map.  Returns
        ``(certainty_map, anomaly_conf)`` where ``anomaly_conf`` is the
        complement (higher = more anomalous).
        """
        probs = np.asarray(probs, np.float64)
        if probs.shape[-1] != self.num_classes:
            raise ValueError(
                f"probs last dim {probs.shape[-1]} != fitted "
                f"{self.num_classes} classes")
        out = np.zeros(probs.shape[:-1], np.float64)
        for cl in range(self.num_classes):
            out += probs[..., cl] * self.certainty_map(dissum, cl)
        return out, 1.0 - out

    # -- persistence (npz: reusable across eval runs) --------------------
    def save(self, path: str):
        payload = {"thresholds": self.thresholds,
                   "mode": np.asarray(self.mode),
                   "clip": np.asarray(self.clip)}
        for cl, s in enumerate(self.sorted_samples):
            payload[f"samples_{cl}"] = s
            mu, var, w = self.gmm_params[cl]
            payload[f"gmm_{cl}"] = np.stack([mu, var, w])
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str):
        z = np.load(path)
        thresholds = z["thresholds"]
        sorted_samples, gmm_params = [], []
        for cl in range(thresholds.shape[0]):
            sorted_samples.append(z[f"samples_{cl}"])
            g = z[f"gmm_{cl}"]
            gmm_params.append((g[0], g[1], g[2]))
        return cls(sorted_samples, thresholds, gmm_params,
                   mode=str(z["mode"]), clip=float(z["clip"]))
