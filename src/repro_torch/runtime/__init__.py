from repro_torch.runtime.knn_server import (KnnServer, QueryResult,
                                            ServerStats)
from repro_torch.runtime.server import ServeConfig, Server

__all__ = ["KnnServer", "QueryResult", "ServeConfig", "Server",
           "ServerStats"]
