"""Command hub: python -m multimodalemotionrecognition_torch <command> ...

  train               src/train.py (on the card)
  eval                src/eval.py (on the card)
  qa-export           src/export_augmented_examples.py
  serve-direct        backend/app/main.py (one clip per request)
  serve-queued        src/inference_server.py with the in-process batcher
  redis-worker        src/inference_worker.py (serving across hosts)
  convert-pretrained  raw torchvision/HF state dict -> branch checkpoint
  convert             inspect a reference-format .pt checkpoint
  make-data           synthetic RAVDESS-style corpus

Not ported yet (exit code 2): export (ROADMAP queue 1, item 7) and
build-native (item 4, the libav loader).
"""

from __future__ import annotations

import sys

_NOT_PORTED = {
    "export": "ROADMAP queue 1, item 7 (runtime/export.py)",
    "build-native": "ROADMAP queue 1, item 4 (the native libav loader)",
}


def _convert(argv) -> None:
    import argparse

    from multimodalemotionrecognition_torch.convert import (
        infer_model_signature,
        load_reference_checkpoint,
    )

    p = argparse.ArgumentParser(prog="convert")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--inspect", action="store_true")
    args = p.parse_args(argv)
    sd, config = load_reference_checkpoint(args.checkpoint)
    print(f"keys: {len(sd)}")
    print(f"config: {config or '(none; signature=' + str(infer_model_signature(sd)) + ')'}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in {"-h", "--help"}:
        print(__doc__)
        return
    command, rest = argv[0], argv[1:]
    if command in _NOT_PORTED:
        print(f"{command}: not ported to the PyTorch package yet; see {_NOT_PORTED[command]}",
              file=sys.stderr)
        raise SystemExit(2)
    if command == "train":
        from multimodalemotionrecognition_torch.train.cli import main as fn
    elif command == "eval":
        from multimodalemotionrecognition_torch.train.eval import main as fn
    elif command == "qa-export":
        from multimodalemotionrecognition_torch.data.qa_export import main as fn
    elif command == "make-data":
        from multimodalemotionrecognition_torch.data.synthetic import main as fn
    elif command == "serve-direct":
        from multimodalemotionrecognition_torch.serving.server_direct import main as fn
    elif command == "serve-queued":
        from multimodalemotionrecognition_torch.serving.server_queued import main as fn
    elif command == "redis-worker":
        from multimodalemotionrecognition_torch.serving.redis_transport import main as fn
    elif command == "convert-pretrained":
        from multimodalemotionrecognition_torch.convert.pretrained import main as fn
    elif command == "convert":
        fn = _convert
    else:
        print(f"Unknown command: {command}\n{__doc__}", file=sys.stderr)
        raise SystemExit(2)
    fn(rest)


if __name__ == "__main__":
    main()
