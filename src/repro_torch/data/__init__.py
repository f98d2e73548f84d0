from .synthetic import (DATASETS, load, make_classification,
                        make_regression, partition)
from .sparse import (CSRMatrix, FeatureShards, SparseShards, csr_to_ell,
                     csr_vstack, ell_to_csr, iter_libsvm_chunks, load_libsvm,
                     make_sparse_classification, partition_sparse,
                     shard_features, shard_features_streaming,
                     shards_from_arrays)
from .tokens import TokenStream
