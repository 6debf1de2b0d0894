from repro_torch.runtime.trainer import (SimulatedNodeFailure, TrainConfig,
                                         init_opt_state, make_train_step,
                                         train_loop)
from repro_torch.runtime.server import ServeConfig, Server
from repro_torch.runtime.knn_server import (KnnServer, QueryResult,
                                            ServerStats)
from repro_torch.runtime.metrics import MetricLogger, StepWatchdog

__all__ = ["KnnServer", "MetricLogger", "QueryResult", "ServeConfig",
           "Server", "ServerStats", "SimulatedNodeFailure", "StepWatchdog",
           "TrainConfig", "init_opt_state", "make_train_step", "train_loop"]
