"""Share (%) of the traced requests whose `htd.backbone_fpn` span holds an
`htd.graph.replay` span: the requests whose backbone and FPN ran as one
CUDA graph's replay (models/graphs.py) rather than launch by launch. None
where the trace holds no `htd.backbone_fpn` span."""


def read(tr, info):
    backbones = [(a, b) for n, a, b in tr.spans if n == "htd.backbone_fpn"]
    if not tr.units or not backbones:
        return None
    replays = [(a, b) for n, a, b in tr.spans if n == "htd.graph.replay"]
    replayed = [any(u0 <= a and b <= u1 and any(a <= r0 and r1 <= b for r0, r1 in replays)
                    for a, b in backbones) for u0, u1 in tr.units]
    return 100.0 * sum(replayed) / len(tr.units)
