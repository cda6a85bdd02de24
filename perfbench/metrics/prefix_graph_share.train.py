"""Share of the frozen WavLM prefix's units (front end, frozen layers) in the traced epoch that the program replayed from CUDA graphs (`wavlm.prefix_replay` spans) rather than ran eagerly (`wavlm.prefix_eager`), %; None where it opens neither span."""

REPLAY, EAGER = "wavlm.prefix_replay", "wavlm.prefix_eager"


def read(run):
    if not run.trace:
        return None
    names = [op[0] for op in run.trace["cpu_ops"]]
    replayed, eager = names.count(REPLAY), names.count(EAGER)
    return 100.0 * replayed / (replayed + eager) if replayed + eager else None
