"""The paper's own workload: distributed hinge-loss SVM / convex ERM solved
with CoCoA+ (repro_torch.core). Production layout: examples sharded over the data
axis (= the paper's K workers), features over the model axis."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CoCoAWorkload:
    name: str = "paper-svm"
    n: int = 8_388_608          # examples (dry-run scale)
    d: int = 16_384             # features (dense stand-in; paper datasets are sparse)
    loss: str = "hinge"
    lam: float = 1e-5
    H: int = 4096               # local steps per round


CONFIG = CoCoAWorkload()
