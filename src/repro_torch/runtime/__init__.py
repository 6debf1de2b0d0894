from repro_torch.runtime.knn_server import (KnnServer, QueryResult,
                                            ServerStats)

__all__ = ["KnnServer", "QueryResult", "ServerStats"]
