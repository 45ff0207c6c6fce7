"""What every driver shares: the counters the harness reads, the log of
work done (shapes for the FLOP and byte counts of ``portbench/metrics``),
the program's model built from the seed's weights, and the comparison
records.

A driver is a class ``Driver(config, traffic, seed, device, limits)``
with
``setup()`` (inputs, weights, warm-up), ``unit()`` (one whole unit of
work, finished on the host; returns the units it completed),
``release()`` (frees the program's state once the window is over),
``check()`` (the comparison with the reference: ``{name: {"value",
"limit"}}``, each value passing at or below its limit) and ``close()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen.weights import make_state


# the work record's keys, from the configuration's model keys
WIDTHS = (("sp_area", "sp_area"), ("fc_width", "fc_width"),
          ("D", "sp_feature_dim"), ("n_classes", "n_classes"))


def check(value, limit) -> dict:
    return {"value": float(value), "limit": float(limit)}


class DriverBase:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict | None = None):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.attempted = 0
        self.failed = 0
        self.window_work = []
        self._work = []
        self.limits = dict(limits or {})
        self.phases = [("start", time.perf_counter())]

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (printed with ``setup_s``)."""
        self.phases.append((name, time.perf_counter()))

    # the harness's interface ------------------------------------------
    def reset_work(self) -> None:
        self._work = []

    def take_work(self) -> list:
        work, self._work = self._work, []
        return work

    def log_work(self, **record) -> None:
        """Log one record of work, with the model's widths that the
        FLOP and byte counts read (those the configuration has)."""
        m = self.config.get("model", {})
        self._work.append(dict(record, **{k: m[key] for k, key in WIDTHS
                                          if key in m}))

    def release(self) -> None:
        pass

    def close(self) -> None:
        pass

    # helpers ----------------------------------------------------------
    def wesup_config(self):
        """The program's ``WESUPConfig`` with the configuration's model
        settings."""
        from wesup_tpu_torch.config import WESUPConfig, merge_config

        return merge_config(WESUPConfig(), **self.config["model"])

    def weights(self) -> dict:
        m = self.config["model"]
        return make_state(self.seed, self.device, fc_width=m["fc_width"],
                          D=m["sp_feature_dim"], n_classes=m["n_classes"])

    def program_model(self):
        """The program's WESUP module holding the seed's weights."""
        from wesup_tpu_torch.models import wesup

        m = self.config["model"]
        self.phase("import")
        model = wesup.empty(self.device, n_classes=m["n_classes"],
                            D=m["sp_feature_dim"], fc_width=m["fc_width"])
        self.phase("module")
        model.load_state_dict(self.weights())
        self.phase("weights")
        return model

    def generator(self, stream: int) -> torch.Generator:
        """A generator on the device for one of the run's input streams."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1000003 + stream) % (1 << 63))
        return gen

    def sample(self, n: int, k: int, stream: int) -> list:
        """``k`` of ``range(n)`` drawn from the seed, sorted."""
        rng = np.random.default_rng([self.seed % (1 << 63), stream])
        return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
