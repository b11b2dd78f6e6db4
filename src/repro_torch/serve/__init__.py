from repro_torch.serve.engine import (BatchedServer, Engine,  # noqa: F401
                                      Request, pad_cache_to)
