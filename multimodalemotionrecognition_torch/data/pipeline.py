"""Host data pipeline: threaded decode + prefetch into fixed-shape batches.

The port's copy of the JAX package's `data/pipeline.py`, which replaces the
reference's torch DataLoader worker processes (`src/train.py:45-73,174-176`)
with a thread pool and a prefetch queue producing padded, fixed-shape numpy
batches.  Threads suffice because decode is C-native (the libav loader,
OpenCV and scipy release the interpreter lock).  RAVDESS `.mp4` video is
read through `data/media.py`: the native libav loader when it is available,
cv2 otherwise or under `EMO_NATIVE_DECODE=0`.  Every batch has the same
shape: the trailing partial batch is zero-padded to `batch_size` with a
`valid` mask.

The producer's threads touch numpy and the decoders only, never CUDA: the
trainer pins and copies each batch on its own side stream
(`EmotionTrainer._stage_batch`).  A sample that fails to load ends the
epoch with its exception in the consumer.

Data parallel (`rank`, `world`): every rank walks the same shuffled order,
cuts the same padded global batches of `batch_size`, and decodes only its
`batch_size // world` rows of each (`rank_rows`): its block of each of the
step's `microbatches`, so that its i-th microbatch is its share of the
global i-th.  A sample's augmentation is keyed by (seed, epoch, index), so
the ranks' rows are the single-process batch's bit for bit; the last
batch's padding and `valid` are the global batch's.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from multimodalemotionrecognition_torch.config import DataConfig
from multimodalemotionrecognition_torch.data.media import (
    load_audio_wav,
    load_noise_bank,
    load_video_frames,
    load_video_frames_u8,
)
from multimodalemotionrecognition_torch.data.ravdess import (
    PairRecord,
    build_pairs,
    map_emotion_label,
    save_pairs_csv,
    split_pairs_by_actor,
    split_pairs_stratified,
)

__all__ = [
    "Batch", "BatchedLoader", "EmotionSampleLoader", "auto_num_threads", "build_loaders", "rank_rows",
]


@dataclass
class Batch:
    """One batch of host arrays.  `audio` is the raw waveform [B, 1, 48000]:
    the mel models get their log-mel spectrogram on the device.

    Two video wire formats (EmotionSampleLoader(wire=...)):
      * "float32": [B,T,3,H,W] float32, host-augmented + ImageNet-normalized
        (`aug` is None);
      * "uint8": [B,T,3,H,W] uint8 post-blur pixels with `aug` [B,2] =
        (brightness_factor, noise_sigma) per sample, 4x less host->device
        traffic; the train step replays brightness, noise, clip and
        normalisation on the device (see media.load_video_frames_u8).
    """

    video: np.ndarray  # [B, T, 3, H, W] float32 normalized, or uint8 wire
    audio: np.ndarray  # [B, 1, samples] float32
    labels: np.ndarray  # [B] int32
    valid: np.ndarray  # [B] bool, False on zero-padded tail entries
    meta: List[Dict[str, int]]
    aug: Optional[np.ndarray] = None  # [B, 2] float32 on the uint8 wire

    @property
    def size(self) -> int:
        return int(self.valid.sum())


class EmotionSampleLoader:
    """Per-sample decode matching the reference datasets
    (`src/data/ravdess.py:581-654`)."""

    def __init__(self, config: DataConfig, augment: bool = False, wire: str = "float32"):
        if wire not in ("float32", "uint8"):
            raise ValueError(f"wire must be 'float32' or 'uint8'; got {wire!r}")
        self.config = config
        self.augment = augment
        self.wire = wire
        self._noise = load_noise_bank(config.noise_wav, config.audio.sample_rate) if augment else None

    def __call__(self, pair: PairRecord, rng: Optional[np.random.RandomState] = None):
        cfg = self.config
        if self.wire == "uint8":
            video, factor, sigma = load_video_frames_u8(
                pair.video_path,
                num_frames=cfg.video.num_frames,
                size=cfg.video.size,
                augment=self.augment,
                use_face_crop=cfg.use_face_crop,
                rng=rng,
            )
            video = (video, np.array([factor, sigma], dtype=np.float32))
        else:
            video = load_video_frames(
                pair.video_path,
                num_frames=cfg.video.num_frames,
                size=cfg.video.size,
                augment=self.augment,
                use_face_crop=cfg.use_face_crop,
                rng=rng,
            )
        audio = load_audio_wav(
            pair.audio_path,
            sample_rate=cfg.audio.sample_rate,
            duration_sec=cfg.audio.duration_sec,
            augment=self.augment,
            noise_bank=self._noise,
            rng=rng,
        )
        label = map_emotion_label(pair.emotion, cfg.num_classes)
        meta = {
            "emotion": pair.emotion,
            "intensity": pair.intensity,
            "statement": pair.statement,
            "repetition": pair.repetition,
            "actor": pair.actor,
        }
        return video, audio, label, meta


def rank_rows(rank: int, world: int, batch_size: int, microbatches: int = 1) -> List[int]:
    """The positions in a global batch of `batch_size` rows that rank `rank`
    of `world` holds when the train step cuts the batch into `microbatches`
    equal parts (`TrainConfig.grad_accum`): its block of each part, in
    order, as the global step's microbatch i is rows [i * B / m, (i + 1) *
    B / m).  One part: the rank's contiguous block."""
    mb = batch_size // microbatches
    n = mb // world
    return [i * mb + rank * n + j for i in range(microbatches) for j in range(n)]


class BatchedLoader:
    """Shuffling, prefetching batch iterator over pair records.

    Epoch e (counted from 1) shuffles with `RandomState(seed + e - 1)` and
    gives sample `idx` its own `RandomState((seed * 100003 + e + idx) %
    2**31)`, so the augmentation of a sample does not depend on the thread
    that decodes it, nor on the rank.  With `world` > 1 each batch holds
    rank `rank`'s `batch_size // world` rows of the global batch, those
    `rank_rows` gives for `microbatches`."""

    def __init__(
        self,
        pairs: Sequence[PairRecord],
        sample_loader: EmotionSampleLoader,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        num_threads: int = 8,
        prefetch: int = 4,
        drop_last: bool = False,
        pad_last: bool = True,
        rank: int = 0,
        world: int = 1,
        microbatches: int = 1,
    ):
        if world > 1 and (batch_size % (world * microbatches) or not pad_last):
            raise ValueError(f"{world} ranks need a padded global batch whose {microbatches} "
                             f"microbatch(es) they divide; got batch_size={batch_size}, "
                             f"pad_last={pad_last}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world}")
        self.rank, self.world = rank, world
        self.positions = rank_rows(rank, world, batch_size, microbatches)
        self.pairs = list(pairs)
        self.sample_loader = sample_loader
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.pad_last = pad_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.pairs)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.pairs)

    def _epoch_order(self) -> List[int]:
        order = np.arange(len(self.pairs))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        return order.tolist()

    def _assemble(self, samples, slots: Sequence[int]) -> Batch:
        """Decoded samples -> a batch holding sample k in row `slots[k]`
        (padding elsewhere)."""
        b = self.batch_size // self.world if self.pad_last else len(slots)
        videos, audios, labels, metas = zip(*samples)
        aug = None
        if isinstance(videos[0], tuple):  # uint8 wire: (frames_u8, aug[2])
            video = np.zeros((b,) + videos[0][0].shape, dtype=np.uint8)
            aug = np.tile(np.array([1.0, 0.0], np.float32), (b, 1))
            for k, i in enumerate(slots):
                video[i], aug[i] = videos[k]
        else:
            video = np.zeros((b,) + videos[0].shape, dtype=np.float32)
            for k, i in enumerate(slots):
                video[i] = videos[k]
        audio = np.zeros((b,) + audios[0].shape, dtype=np.float32)
        label_arr = np.zeros((b,), dtype=np.int32)
        valid = np.zeros((b,), dtype=bool)
        for k, i in enumerate(slots):
            audio[i] = audios[k]
            label_arr[i] = labels[k]
            valid[i] = True
        return Batch(
            video=video, audio=audio, labels=label_arr, valid=valid,
            meta=list(metas[:len(slots)]), aug=aug,
        )

    def __iter__(self) -> Iterator[Batch]:
        order = self._epoch_order()
        self._epoch += 1
        base_seed = self.seed * 100003 + self._epoch
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue `item` unless the consumer has gone; -> whether it went in."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    for batch_indices in batches:
                        if stop.is_set():
                            return
                        slots = [i for i, p in enumerate(self.positions) if p < len(batch_indices)]
                        mine = [batch_indices[self.positions[i]] for i in slots]
                        futures = [
                            pool.submit(
                                self.sample_loader,
                                self.pairs[idx],
                                np.random.RandomState((base_seed + idx) % (2**31)),
                            )
                            for idx in mine or batch_indices[:1]
                        ]
                        # A rank with no valid row of the last batch decodes
                        # the batch's first sample for the shapes alone.
                        samples = [f.result() for f in futures]
                        if not put(self._assemble(samples, slots)):
                            return
            except Exception as exc:  # handed to the consumer, which raises it
                put(exc)
                return
            put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def auto_num_threads(requested: int = -1) -> int:
    """Decode-thread policy (reference `_build_loader_kwargs`,
    `src/train.py:45-73`, minus the WSL special cases): explicit value wins;
    auto = min(8, max(2, cpus//2))."""
    if requested >= 0:
        return max(1, requested)
    import os

    cpus = os.cpu_count() or 4
    return min(8, max(2, cpus // 2))


def build_loaders(
    config: DataConfig, batch_size: int, num_workers: int = -1, wire: str = "float32",
    rank: int = 0, world: int = 1, microbatches: int = 1,
):
    """Pairs -> (train, val, test) loaders; mirrors `build_dataloaders`
    (`src/train.py:76-182`): pairs.csv written to the working directory
    (by rank 0), stratified seed-42 or actor-based splits, augmentation on
    train only.  wire="uint8" selects the low-traffic video wire (see
    Batch); `rank` and `world` give each loader rank `rank`'s rows of every
    global batch of `batch_size`, the train loader's cut for a step of
    `microbatches` (`rank_rows`)."""
    pairs = build_pairs(config.data_root, vocal_channel=config.vocal_channel)
    if not pairs:
        raise RuntimeError("No audio-video pairs found. Check data_root and filenames.")
    if rank == 0:
        save_pairs_csv(pairs, "pairs.csv")

    if config.split_mode == "stratified":
        test_ratio = max(0.0, 1.0 - config.train_ratio - config.val_ratio)
        train_p, val_p, test_p = split_pairs_stratified(
            pairs,
            train_ratio=config.train_ratio,
            val_ratio=config.val_ratio,
            test_ratio=test_ratio,
            seed=42,
        )
    else:
        train_p, val_p, test_p = split_pairs_by_actor(
            pairs, config.train_actors, config.val_actors, config.test_actors
        )

    threads = auto_num_threads(num_workers)
    train_loader = BatchedLoader(
        train_p,
        EmotionSampleLoader(config, augment=config.train_augment, wire=wire),
        batch_size,
        shuffle=True,
        seed=config.seed,
        num_threads=threads,
        rank=rank,
        world=world,
        microbatches=microbatches,
    )
    val_loader = BatchedLoader(
        val_p, EmotionSampleLoader(config, augment=False, wire=wire), batch_size,
        num_threads=threads, rank=rank, world=world,
    )
    test_loader = BatchedLoader(
        test_p, EmotionSampleLoader(config, augment=False, wire=wire), batch_size,
        num_threads=threads, rank=rank, world=world,
    )
    return train_loader, val_loader, test_loader
