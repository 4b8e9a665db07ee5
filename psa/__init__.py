"""psa — parallel mutant-alignment search engine on an NVIDIA GPU.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C/OpenMP/MPI/CUDA project (GuyKabiri/Parallel-Sequence-Alignment):

    Given sequences Seq1, Seq2 (len2 <= len1), four weights w1..w4 and a mode
    (maximum/minimum), search every (offset, position, substitution character)
    triple for the best-scoring single-character mutation of Seq2.

Architecture (a re-design, not a port):

* all character-pair logic (sign classes, substitution legality, score deltas)
  is hoisted into tiny host-precomputed constant tables (`core.tables`),
* the device inner loop is a table-lookup sweep with integer count and max
  accumulation (`ops.pallas_sweep`, a Pallas kernel through Triton;
  `ops.engine_xla` / `ops.engine_conv` pure-XLA paths), producing *exact*
  integer per-offset statistics,
* winner selection happens in exact float64 semantics on the host
  (`ops.select`), including the reference's canonical tie-break
  (best score -> lowest offset -> lowest char position -> alphabetically
  first substitute),
* multi-chip scaling shards the offset axis over a `jax.sharding.Mesh`
  with `shard_map` (`parallel.mesh`), replacing the reference's MPI split.
"""

from psa.core.alphabet import encode, decode
from psa.core.tables import ScoringTables, build_tables
from psa.core.result import SearchResult, NoMutationFound
from psa.models.search import AlignmentSearchEngine, search
from psa.utils.io import Query


def search_batch(queries, backend: str = "auto",
                 strict_alphabet: bool = True, mesh=None):
    """Lazy re-export of models.batch.search_batch (importing the batch
    module pulls in jax; the single-query surfaces above do not)."""
    from psa.models.batch import search_batch as _sb

    return _sb(queries, backend=backend, strict_alphabet=strict_alphabet,
               mesh=mesh)


__all__ = [
    "encode",
    "decode",
    "ScoringTables",
    "build_tables",
    "SearchResult",
    "NoMutationFound",
    "AlignmentSearchEngine",
    "search",
    "search_batch",
    "Query",
]

__version__ = "0.1.0"
