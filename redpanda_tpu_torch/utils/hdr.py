"""Log-bucketed latency histogram (the JAX package's utils/hdr.py, copied:
the port imports nothing of that package).

Parity surface of utils/hdr_hist.h (the reference wraps HdrHistogram for
kafka latency probes, latency_probe.h:33-43): record values, query
percentiles, export cumulative buckets in prometheus histogram form. The
bucket layout is powers-of-two sub-divided into 4 (≈19% worst-case relative
error), which matches what the dashboards need without the full HDR tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_SUBBUCKETS = 4


def _bucket_of(value: int) -> int:
    if value < 1:
        value = 1
    exp = value.bit_length() - 1
    base = 1 << exp
    sub = ((value - base) * _SUBBUCKETS) >> exp  # 0.._SUBBUCKETS-1
    return exp * _SUBBUCKETS + sub


def _bucket_upper(idx: int) -> int:
    exp, sub = divmod(idx, _SUBBUCKETS)
    base = 1 << exp
    # ceil division: for base < _SUBBUCKETS a floor would yield an upper
    # bound BELOW values the bucket contains (e.g. record(1) → le="0")
    width = ((sub + 1) * base + _SUBBUCKETS - 1) // _SUBBUCKETS
    return base + width - 1


@dataclass
class HdrHist:
    unit: str = "us"
    _counts: dict[int, int] = field(default_factory=dict)
    _total: int = 0
    _sum: int = 0
    _max: int = 0

    def record(self, value: int) -> None:
        idx = _bucket_of(int(value))
        self._counts[idx] = self._counts.get(idx, 0) + 1
        self._total += 1
        self._sum += int(value)
        if value > self._max:
            self._max = int(value)

    @property
    def count(self) -> int:
        return self._total

    @property
    def sum(self) -> int:
        return self._sum

    @property
    def max(self) -> int:
        return self._max

    def mean(self) -> float:
        return self._sum / self._total if self._total else 0.0

    def percentile(self, p: float) -> int:
        """p in [0, 100]; returns the bucket upper bound at that rank."""
        if not self._total:
            return 0
        target = max(1, int(round(self._total * p / 100.0)))
        seen = 0
        # sorted(items()) materializes the dict in ONE GIL-atomic C call:
        # readers (the /metrics scrape, the SLO engine's snapshot) run on
        # other threads than some writers (harvester/executor stage
        # records), and iterating the live dict would raise "changed size
        # during iteration" the moment a writer occupies a new bucket —
        # i.e. exactly during the incident being judged. A point-in-time
        # smear against _total is acceptable; a crash is not.
        items = sorted(self._counts.items())
        for idx, n in items:
            seen += n
            if seen >= target:
                return _bucket_upper(idx)
        return _bucket_upper(items[-1][0]) if items else 0

    def cumulative_buckets(self) -> list[tuple[int, int]]:
        """[(upper_bound, cumulative_count)] for prometheus exposition.
        Safe against concurrent record(): see percentile()."""
        out = []
        seen = 0
        for idx, n in sorted(self._counts.items()):
            seen += n
            out.append((_bucket_upper(idx), seen))
        return out
