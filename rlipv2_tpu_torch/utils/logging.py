"""Training metrics and logging (a copy of SmoothedValue, MetricLogger and
append_log_line in rlipv2_tpu/utils/logging.py; reference
util/misc.py:40-262): windowed medians and averages, iteration timing with
ETA, periodic log lines, and the per-epoch JSON log."""

from __future__ import annotations

import datetime
import json
import time
from collections import defaultdict, deque
from pathlib import Path


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0 or (n is not None and i == n - 1):
                if n:
                    eta = str(
                        datetime.timedelta(seconds=int(iter_time.avg * (n - i)))
                    )
                    self.print_fn(
                        f"{header} [{i}/{n}] eta: {eta} {self} "
                        f"time: {iter_time}"
                    )
                else:
                    self.print_fn(f"{header} [{i}] {self} time: {iter_time}")
        total = time.time() - start
        self.print_fn(
            f"{header} Total time: {datetime.timedelta(seconds=int(total))}"
        )


def append_log_line(output_dir, record: dict) -> None:
    """Append one JSON line to `output_dir`/log.txt (reference:
    main.py:790-792)."""
    p = Path(output_dir)
    p.mkdir(parents=True, exist_ok=True)
    with open(p / "log.txt", "a") as f:
        f.write(json.dumps(record) + "\n")
