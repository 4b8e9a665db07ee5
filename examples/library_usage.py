"""Library quickstart: the three public surfaces of psa.

Run: PYTHONPATH=. python examples/library_usage.py        (CPU-safe; ~seconds)

Reference workflow analog: main.c:13-56 (read input -> search -> write),
but as a library — the reference has no importable API at all.
"""

import os

import numpy as np

# Force CPU with 8 virtual devices so the example runs (and demonstrates
# sharding) anywhere, with the device kernel in Pallas interpret mode;
# delete this block on a GPU host.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ["PSA_INTERPRET"] = "1"
import jax

jax.config.update("jax_platforms", "cpu")


def single_query():
    """One (Seq1, Seq2) search with the reference's exact semantics."""
    from psa.models.search import AlignmentSearchEngine
    from psa.utils.generator import random_sequences

    seq1, seq2 = random_sequences(5_000, 800, seed=0)
    # weights = (w1, w2, w3, w4); False = minimum mode ("maximum" -> True)
    engine = AlignmentSearchEngine(np.array([1.0, 3.0, 4.0, 2.0]),
                                   is_max=False, backend="auto")
    res = engine.search(seq1, seq2)
    print(f"single: offset={res.offset} char_offset={res.char_offset} "
          f"substitute={res.sub_char} score={res.score:g}")
    print(f"        mutant[:40] = {res.mutant(seq2)[:40]}...")


def batch_serving():
    """Many queries at once: bucketed by shape, streamed in microbatches."""
    from psa.models.batch import search_batch
    from psa.utils.generator import random_sequences
    from psa.utils.io import Query

    queries = []
    for seed, (n1, n2) in enumerate([(3_000, 500), (3_000, 500),
                                     (1_200, 200)]):
        s1, s2 = random_sequences(n1, n2, seed=seed)
        queries.append(Query(weights=np.array([1.0, 3.0, 4.0, 2.0]),
                             seq1=s1, seq2=s2, is_max=False))
    results = search_batch(queries, backend="auto")
    for i, r in enumerate(results):
        print(f"batch[{i}]: offset={r.offset} score={r.score:g}"
              if r else f"batch[{i}]: no mutation")


def sharded_multichip():
    """Offset axis sharded over every local device (mesh analog of the
    reference's MPI split, cpu_funcs.c:128-133)."""
    from psa.core.alphabet import encode
    from psa.core.tables import build_tables
    from psa.parallel.mesh import search_sharded
    from psa.utils.generator import random_sequences

    seq1, seq2 = random_sequences(20_000, 2_000, seed=1)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    res = search_sharded(encode(seq1), encode(seq2), tables, kernel="auto")
    print(f"sharded ({jax.device_count()} devices): offset={res.offset} "
          f"score={res.score:g}")


def sharded_auto_2d():
    """Workload-aware mesh shape: small-offset-count searches get a char
    axis (counts psum_scatter + rank pmax over Seq2 chunks, exact by
    construction); long-Seq1 searches stay offset-sharded.  This is what
    the CLI --sharded flag routes through."""
    from psa.core.alphabet import encode
    from psa.core.tables import build_tables
    from psa.parallel.mesh import choose_mesh_shape, search_sharded_auto
    from psa.utils.generator import random_sequences

    seq1, seq2 = random_sequences(6_000, 2_000, seed=2)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    shape = choose_mesh_shape(jax.device_count(), len(seq1) - len(seq2) + 1,
                              len(seq2))
    res = search_sharded_auto(encode(seq1), encode(seq2), tables)
    print(f"sharded-auto (mesh {shape[0]}x{shape[1]} op x ch): "
          f"offset={res.offset} score={res.score:g}")


def sharded_batch_serving():
    """Query axis sharded over every local device: each device sweeps its
    own block of queries (no collectives), selection stays bit-exact."""
    from psa.core.alphabet import encode, pad_codes
    from psa.core.tables import build_tables
    from psa.models.batch import batched_search_exact_sharded
    from psa.parallel.mesh import make_mesh
    from psa.utils.generator import random_sequences

    n1, n2, l2p = 1_000, 120, 128
    l1k = 1024 + l2p
    B = 6
    c1b, c2b = [], []
    for seed in range(B):
        s1, s2 = random_sequences(n1, n2, seed=seed)
        c1b.append(pad_codes(encode(s1), l1k))
        c2b.append(pad_codes(encode(s2), l2p))
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    mesh = make_mesh(jax.devices(), axis="dp")
    results = batched_search_exact_sharded(
        np.stack(c1b), np.stack(c2b),
        np.full(B, n1 - n2 + 1, np.int32), np.full(B, n2, np.int32),
        tables, mesh)
    print(f"sharded batch ({jax.device_count()} devices): "
          + " ".join(f"{r.offset}" for r in results))


if __name__ == "__main__":
    single_query()
    batch_serving()
    sharded_multichip()
    sharded_auto_2d()
    sharded_batch_serving()
