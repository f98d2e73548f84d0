from .synthetic import (DATASETS, load, make_classification,
                        make_regression, partition)
from .sparse import (CSRMatrix, FeatureShards, SparseShards, csr_to_ell,
                     make_sparse_classification, partition_sparse,
                     shard_features, shards_from_arrays)
from .tokens import TokenStream
