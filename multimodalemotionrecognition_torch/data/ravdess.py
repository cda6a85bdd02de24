"""RAVDESS pairing, label mapping, and split strategies.

The port's copy of the JAX package's `data/ravdess.py`, line for line.
Pure-host metadata layer with the same observable semantics as the reference
(`src/data/ravdess.py:54-269`): 7-field filename parsing, pairing of
video-only (modality 02, .mp4) with audio-only (modality 03, .wav) files on
(vocal_channel, emotion, intensity, statement, repetition, actor), the 8/4
class label maps, actor-based and stratified (seed-42) splits, and pairs.csv
export.
"""

from __future__ import annotations

import csv
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

__all__ = [
    "EMOTION_ID_TO_NAME",
    "PairRecord",
    "parse_ravdess_name",
    "build_pairs",
    "save_pairs_csv",
    "map_emotion_label",
    "split_pairs_by_actor",
    "split_pairs_stratified",
]

EMOTION_ID_TO_NAME = {
    1: "neutral",
    2: "calm",
    3: "happy",
    4: "sad",
    5: "angry",
    6: "fearful",
    7: "disgust",
    8: "surprised",
}

_PAIR_KEY_FIELDS = (
    "vocal_channel",
    "emotion",
    "intensity",
    "statement",
    "repetition",
    "actor",
)


def parse_ravdess_name(filename: str) -> Dict[str, int]:
    """Parse `02-01-06-01-02-01-12.mp4`-style names into the 7 RAVDESS fields
    (reference `src/data/ravdess.py:54-72`)."""
    stem = Path(filename).stem
    parts = stem.split("-")
    if len(parts) != 7:
        raise ValueError(f"Unexpected RAVDESS name: {filename}")
    fields = list(map(int, parts))
    return {
        "modality": fields[0],
        "vocal_channel": fields[1],
        "emotion": fields[2],
        "intensity": fields[3],
        "statement": fields[4],
        "repetition": fields[5],
        "actor": fields[6],
    }


@dataclass(frozen=True)
class PairRecord:
    video_path: Path
    audio_path: Path
    emotion: int
    intensity: int
    statement: int
    repetition: int
    actor: int


def build_pairs(data_root: Path | str, vocal_channel: int = 1) -> List[PairRecord]:
    """Pair video-only .mp4 (modality 02) with audio-only .wav (modality 03)
    on the 6-field key; unpaired files are dropped
    (reference `src/data/ravdess.py:108-174`)."""
    data_root = Path(data_root)
    video_map: Dict[Tuple[int, ...], Path] = {}
    audio_map: Dict[Tuple[int, ...], Path] = {}

    for path in data_root.rglob("*"):
        if not path.is_file() or path.suffix.lower() not in {".mp4", ".wav"}:
            continue
        try:
            fields = parse_ravdess_name(path.name)
        except ValueError:
            continue
        if fields["vocal_channel"] != vocal_channel:
            continue
        key = tuple(fields[f] for f in _PAIR_KEY_FIELDS)
        if fields["modality"] == 2 and path.suffix.lower() == ".mp4":
            video_map[key] = path
        elif fields["modality"] == 3 and path.suffix.lower() == ".wav":
            audio_map[key] = path

    pairs = []
    for key in sorted(video_map.keys() & audio_map.keys()):
        pairs.append(
            PairRecord(
                video_path=video_map[key],
                audio_path=audio_map[key],
                emotion=key[1],
                intensity=key[2],
                statement=key[3],
                repetition=key[4],
                actor=key[5],
            )
        )
    return pairs


def save_pairs_csv(pairs: Iterable[PairRecord], csv_path: Path | str) -> None:
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    with csv_path.open("w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["video_path", "audio_path", "emotion", "intensity", "statement", "repetition", "actor"]
        )
        for p in pairs:
            writer.writerow(
                [str(p.video_path), str(p.audio_path), p.emotion, p.intensity, p.statement, p.repetition, p.actor]
            )


def map_emotion_label(emotion_id: int, num_classes: int) -> int:
    """8-class: id-1; 4-class grouping per reference
    (`src/data/ravdess.py:189-202`)."""
    if num_classes == 8:
        return emotion_id - 1
    if num_classes != 4:
        raise ValueError("num_classes must be 8 or 4")
    if emotion_id in {1, 2}:
        return 0
    if emotion_id == 3:
        return 1
    if emotion_id in {4, 5, 6, 7}:
        return 2
    if emotion_id == 8:
        return 3
    raise ValueError(f"Unknown emotion id: {emotion_id}")


def split_pairs_by_actor(
    pairs: List[PairRecord],
    train_actors: Iterable[int],
    val_actors: Iterable[int],
    test_actors: Iterable[int],
) -> Tuple[List[PairRecord], List[PairRecord], List[PairRecord]]:
    train_set, val_set, test_set = set(train_actors), set(val_actors), set(test_actors)
    train, val, test = [], [], []
    for p in pairs:
        if p.actor in train_set:
            train.append(p)
        elif p.actor in val_set:
            val.append(p)
        elif p.actor in test_set:
            test.append(p)
    return train, val, test


def split_pairs_stratified(
    pairs: List[PairRecord],
    train_ratio: float = 0.7,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    seed: int = 42,
) -> Tuple[List[PairRecord], List[PairRecord], List[PairRecord]]:
    """Per-emotion shuffled split with floor-sized train/val buckets
    (reference `src/data/ravdess.py:225-269`; same ambient-RNG protocol so the
    same seed yields the same partition sizes)."""
    rng = random.Random(seed)
    groups: Dict[int, List[PairRecord]] = {}
    for p in pairs:
        groups.setdefault(p.emotion, []).append(p)

    train, val, test = [], [], []
    for emotion_pairs in groups.values():
        rng.shuffle(emotion_pairs)
        n = len(emotion_pairs)
        n_train = int(n * train_ratio)
        n_val = int(n * val_ratio)
        train.extend(emotion_pairs[:n_train])
        val.extend(emotion_pairs[n_train : n_train + n_val])
        test.extend(emotion_pairs[n_train + n_val :])
    return train, val, test
