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
  export              src/export_optimized_model.py: torch.export artifact + meta.json (on the card)
  build-native        build the native libav media loader, print its path
"""

from __future__ import annotations

import sys


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


def _build_native(argv) -> None:
    import argparse

    from multimodalemotionrecognition_torch.native.build import build

    argparse.ArgumentParser(prog="build-native").parse_args(argv)
    print(build())


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in {"-h", "--help"}:
        print(__doc__)
        return
    command, rest = argv[0], argv[1:]
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
    elif command == "export":
        from multimodalemotionrecognition_torch.runtime.export import main as fn
    elif command == "convert":
        fn = _convert
    elif command == "build-native":
        fn = _build_native
    else:
        print(f"Unknown command: {command}\n{__doc__}", file=sys.stderr)
        raise SystemExit(2)
    fn(rest)


if __name__ == "__main__":
    main()
