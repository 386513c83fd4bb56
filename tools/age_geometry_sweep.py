#!/usr/bin/env python3
"""Time the AGE kernel's walk over a grid of launch geometries on one CUDA card.

Run from the root of a checkout on a machine with a Hopper card and the CUDA
toolkit:

    python3 tools/age_geometry_sweep.py [--archs gcn gin] [--groups 1 2 4] [--lanes 4 8]

For each arch it serves the FULL config once on the Yelp graph (716,847
nodes, 300 features, seed 0) to build its plans, then times
``kernels/segment_agg/ops.py``'s kernel on the four AGE calls of a request
(int8 group on codes at D 300, stride 304, and at D 256; float group on f32
rows at D 300 and 256) with every (lane groups, lanes per ring stage) pair of
the grid, beside the geometry ``walk_geometry(aligned=True)`` picks. Each
time is the median of three runs of five launches, by CUDA events. Every
geometry must give the default launch's output bitwise (each segment is summed
in lane order whatever the groups); the script exits 1 if one does not.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=["gcn", "gin"])
    ap.add_argument("--groups", nargs="+", type=int, default=[1, 2, 3, 4, 5, 6, 8])
    ap.add_argument("--lanes", nargs="+", type=int, default=[2, 4, 8, 12, 16])
    args = ap.parse_args()

    import torch

    import chip_smoke as smoke
    from repro_torch.configs.base import get_config
    from repro_torch.core.aggregation import _int8_rows
    from repro_torch.core.quantization import compute_scale_zp, quantize
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.models.gnn import api
    from repro_torch.serve.gnn_engine import GNNServeEngine

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smoke.phase_build()
    g = make_dataset("yelp", max_feature_dim=300, seed=0)
    ok = True
    for arch in args.archs:
        cfg = get_config(f"ample-{arch}")
        srv = GNNServeEngine(cfg)
        srv.infer(g, g.features)
        entry = smoke._yelp_engine(srv, g)
        n, mode = entry.graph.num_nodes, api.agg_mode(cfg)
        dplans = entry._device_plans(mode, entry.plans(mode), torch.device("cuda"))
        x300 = torch.from_numpy(srv._pad_features(g.features, n)).cuda()
        x256 = torch.randn((n, 256), generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda")
        for tag, x, kind in (("int8", x300, "codes"), ("int8", x256, "codes"),
                             ("float", x300, "f32"), ("float", x256, "f32")):
            dp, qp, rows = dplans[tag], None, x
            if kind == "codes":
                qp = compute_scale_zp(x, symmetric=True)
                rows = _int8_rows(x, qp) if x.shape[1] % 16 else quantize(x, qp)
            plan = (dp.gather_idx, dp.coeff, dp.seg_ids, dp.out_node, dp.split)
            lanes, segs = dp.gather_idx.shape[1], dp.out_node.shape[1]
            d, elem = rows.shape[1], rows.element_size()
            default = seg_ops.walk_geometry(lanes, segs, 1, d, elem, rows.data_ptr(),
                                            rows.stride(0), aligned=True)
            want = seg_ops.aggregate_tiles(rows, *plan, num_nodes=n, qp=qp).clone()
            walks = [default]
            for gr in args.groups:
                for k in args.lanes:
                    try:
                        walks.append(seg_ops._walk(lanes, segs, 1, d, elem,
                                                   default.chunk_bytes, gr, k))
                    except ValueError as err:  # more threads or shared memory than a block has
                        print(f"[sweep] {arch} {tag} {kind} D={d} groups={gr} "
                              f"lanes_per_stage={k}: skipped ({err})")
            for i, wk in enumerate(walks):
                out = torch.zeros((n, d), device="cuda")

                def run(wk=wk, out=out):
                    return seg_ops._launch(rows, qp, *plan, n, out, wk)

                same = bool(torch.equal(run(), want))
                ms = sorted(smoke.cuda_ms(run, reps=5) for _ in range(3))[1]
                ok &= same
                print(f"[sweep] {arch} {tag} {kind} D={d} stride={rows.stride(0)} "
                      f"groups={wk.groups} lanes_per_stage={wk.lanes_per_stage} "
                      f"threads={wk.threads}{' (default)' if i == 0 else ''}: {ms:.3f} ms "
                      f"bitwise={same}", flush=True)
        del srv, entry, dplans, x300, x256
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
