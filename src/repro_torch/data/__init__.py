from repro_torch.data.synthetic import (SyntheticStream,  # noqa: F401
                                        make_stream)
