from repro_torch.runtime.controller import (Controller,  # noqa: F401
                                            ControllerConfig,
                                            CostCalibrator,
                                            decide_repartition, decide_scale,
                                            suggest_knobs)
from repro_torch.runtime.dispatcher import (AdmissionFull,  # noqa: F401
                                            DeadlineExceeded, Dispatcher,
                                            DispatcherCodecs, NodeError,
                                            ReplayStats, RetryPolicy)
from repro_torch.runtime.engine import (EngineReport,  # noqa: F401
                                        InferenceEngine)
from repro_torch.runtime.supervisor import (Supervisor,  # noqa: F401
                                            SupervisorConfig,
                                            supervised_engine)
from repro_torch.runtime.topology import StageSpec, TopologySpec  # noqa: F401
from repro_torch.runtime.transport import (Channel,  # noqa: F401
                                           ChannelClosed, InprocTransport,
                                           LinkTransport, TcpTransport,
                                           Transport, get_transport,
                                           register_transport,
                                           register_transport_scheme)
from repro_torch.runtime.wire import (BatchEnvelope, Envelope,  # noqa: F401
                                      NodePlan, ReconfigMarker, RowExtent,
                                      WireCodec, WireFormatError, WireRecord,
                                      frame, unframe, unframe_compat)
