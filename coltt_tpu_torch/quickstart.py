"""Quickstart: the three engines of the port, end to end, in one script.

    python -m coltt_tpu_torch.quickstart [workdir] [--device cuda|cpu]

The counterpart of the JAX package's ``examples/quickstart.py``: the user
journey (create -> index -> search -> filter -> persist -> reload) through
each mode, with the same seed, data, asserts and printed lines. Every
engine gets ``--device`` (default ``cuda``; without a card that fails,
``--device cpu`` runs it on the host in seconds). The work directory
defaults to a new temporary one.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from coltt_tpu_torch import (
    CollectionSchema, FieldSchema, FieldType, Filter, Op, Quantization,
)
from coltt_tpu_torch.engine.core import CollectionSpec, CoreEngine
from coltt_tpu_torch.engine.edge import EdgeEngine
from coltt_tpu_torch.engine.experimental import ExperimentalEngine
from coltt_tpu_torch.storage.objectstore import LocalObjectStore

DIM = 128
SEED = 7


def edge_demo(root: str, rng: np.random.Generator, device: str) -> None:
    """Edge mode: quantized FLAT collections with metadata filters."""
    eng = EdgeEngine(LocalObjectStore(f"{root}/objects"), device=device)
    eng.create_collection(CollectionSchema(
        name="docs", dim=DIM, quantization=Quantization.F8,
        fields=(FieldSchema("pk", FieldType.STRING, primary_key=True),
                FieldSchema("lang", FieldType.STRING),
                FieldSchema("stars", FieldType.INTEGER)),
    ))
    vecs = rng.standard_normal((1000, DIM)).astype(np.float32)
    eng.index_many(
        "docs",
        [{"pk": f"d{i}", "lang": "go" if i % 2 else "py", "stars": i % 50}
         for i in range(1000)],
        vecs,
    )
    hits = eng.search("docs", vecs[42], limit=3)
    assert hits[0].id == "d42"
    filtered = eng.search(
        "docs", vecs[42], limit=3,
        filter_expression=Filter("lang", Op.EQ, "py"),
    )
    assert all(h.metadata["lang"] == "py" for h in filtered)
    eng.flush("docs")
    eng.release_collection("docs")
    eng.load_collection("docs")   # rehydrates from the object store
    again = eng.search("docs", vecs[42], limit=1)
    assert again[0].id == "d42"
    print(f"edge: top hit d42 score={hits[0].score:.1f}, "
          f"filtered+persisted OK")


def core_demo(root: str, rng: np.random.Generator, device: str) -> None:
    """Root mode: HNSW graph collections over a WAL-backed commit log."""
    eng = CoreEngine(f"{root}/core", device=device)
    eng.create_collection(CollectionSpec(name="vectors", dim=DIM))
    vecs = rng.standard_normal((2000, DIM)).astype(np.float32)
    ids = eng.bulk_insert(
        "vectors", vecs, [{"bucket": str(i % 4)} for i in range(2000)]
    )
    hits = eng.vector_search("vectors", vecs[7], top_k=3)
    assert hits[0].id == ids[7]
    hybrid = eng.hybrid_search("vectors", vecs[8], {"bucket": "0"}, top_k=3)
    assert all(h.metadata["bucket"] == "0" for h in hybrid)
    eng.release_collection("vectors")  # snapshots graph + bitmap index
    eng.load_collection("vectors")
    print(f"core: HNSW top hit {hits[0].id} score={hits[0].score:.1f}, "
          f"hybrid search + snapshot OK")
    eng.close()


def multivector_demo(root: str, rng: np.random.Generator, device: str) -> None:
    """Experimental mode: CFLAT weighted multi-vector records."""
    eng = ExperimentalEngine(LocalObjectStore(f"{root}/mv_objects"), device=device)
    eng.create_collection(CollectionSchema(
        name="products", dim=DIM,
        fields=(FieldSchema("pk", FieldType.STRING, primary_key=True),
                FieldSchema("title_vec", FieldType.VECTOR),
                FieldSchema("image_vec", FieldType.VECTOR)),
    ))
    title = rng.standard_normal((500, DIM)).astype(np.float32)
    image = rng.standard_normal((500, DIM)).astype(np.float32)
    for i in range(500):
        eng.index("products", f"p{i}",
                  {"title_vec": title[i], "image_vec": image[i]},
                  {"pk": f"p{i}"})
    hits = eng.vector_search(
        "products",
        [("title_vec", title[33], True, 70.0),
         ("image_vec", image[33], True, 30.0)],
        top_k=3,
    )
    assert hits[0].id == "p33"
    print(f"experimental: weighted 2-vector top hit p33 "
          f"score={hits[0].score:.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=None,
                    help="where the engines keep their files (default: a new "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the torch device of every engine (default: cuda)")
    args = ap.parse_args(argv)
    root = args.workdir or tempfile.mkdtemp(prefix="coltt_")
    rng = np.random.default_rng(SEED)
    print(f"workdir: {root}")
    edge_demo(root, rng, args.device)
    core_demo(root, rng, args.device)
    multivector_demo(root, rng, args.device)
    print("all three engines OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
