from repro_torch.data.logistic import (LogisticProblem,  # noqa: F401
                                       dirichlet_noniid_problem,
                                       make_logistic_problem)
from repro_torch.data.synthetic import (SyntheticStream,  # noqa: F401
                                        make_stream)
