"""Deterministic synthetic token stream (torch twin of
``repro.data.pipeline``): a Zipf-distributed Markov chain over a fixed
random successor table, documents of exponential length packed back to
back with EOS separators. ``batch_at(step, host_slice)`` is a pure
function of (seed, step) and equals the JAX package's batch for the same
config: a restarted job replays its batches bit for bit, and a host can
build only its own rows. :func:`shard_batch` places a batch on one
device, or a data rank's rows of it on a mesh."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 512
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 1234
    eos_id: int = 0
    mean_doc_len: int = 96
    zipf_a: float = 1.3


class SyntheticLM:
    """Zipf-Markov synthetic language with deterministic per-step
    batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.n_succ = 8
        self.succ = rng.integers(1, cfg.vocab, size=(cfg.vocab, self.n_succ),
                                 dtype=np.int32)
        p = 1.0 / np.arange(1, self.n_succ + 1) ** cfg.zipf_a
        self.slot_p = (p / p.sum()).astype(np.float64)

    def _doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        t = int(rng.integers(1, self.cfg.vocab))
        for i in range(length):
            out[i] = t
            t = int(self.succ[t, rng.choice(self.n_succ, p=self.slot_p)])
        return out

    def _packed_row(self, row_seed: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(row_seed)
        toks: list = []
        while len(toks) < cfg.seq_len + 1:
            length = max(4, int(rng.exponential(cfg.mean_doc_len)))
            toks.extend(self._doc(rng, length).tolist())
            toks.append(cfg.eos_id)
        return np.asarray(toks[: cfg.seq_len + 1], np.int32)

    def batch_at(self, step: int, host_slice: Optional[slice] = None
                 ) -> Dict[str, np.ndarray]:
        """Pure function of step -> {'tokens', 'targets'} (B, S); with
        ``host_slice`` only those rows of the global batch."""
        cfg = self.cfg
        rows = range(cfg.global_batch)[host_slice or slice(None)]
        packed = np.stack([
            self._packed_row(cfg.seed * 1_000_003 + step * cfg.global_batch
                             + r)
            for r in rows])
        return {"tokens": packed[:, :-1], "targets": packed[:, 1:]}

    def iter_batches(self, start_step: int = 0) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def data_rows(batch_rows: int, microbatch: int, data_rank: int,
              data_ways: int) -> np.ndarray:
    """The global batch rows a data rank holds: its contiguous 1/D slice
    of EACH microbatch (``microbatch`` rows; 0: the whole batch is one),
    in order. B=8, microbatch 4, D=2: rank 0 holds rows 0, 1, 4, 5. A
    data-sharded train step's microbatch i is then the reference's
    microbatch i, its rows cut over data as the reference's dispatch cuts
    them (MoE capacity and the aux loss are per microbatch)."""
    mb = microbatch if 0 < microbatch < batch_rows else batch_rows
    if batch_rows % mb or mb % data_ways:
        raise ValueError(f"batch {batch_rows}, microbatch {mb}: the "
                         f"microbatch must divide the batch and split "
                         f"{data_ways} ways over data")
    per = mb // data_ways
    starts = np.arange(0, batch_rows, mb) + data_rank * per
    return (starts[:, None] + np.arange(per)[None, :]).reshape(-1)


def shard_batch(batch: Dict[str, np.ndarray], device, *,
                data_rank: int = 0, data_ways: int = 1,
                microbatch: int = 0) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays) as tensors on ``device``: the whole
    batch (the one-device form of JAX's ``shard_batch``), or with
    ``data_ways`` > 1 the rows :func:`data_rows` gives this data rank."""
    if data_ways > 1:
        rows = data_rows(len(next(iter(batch.values()))), microbatch,
                         data_rank, data_ways)
        batch = {k: v[rows] for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
