"""Federation API: FedKT's one-round protocol (``repro.federation``).

    Party / Server / FedKTSession  — the protocol (who sends what, once)
    bindings.PartyBinding           — what ONE party brings to a round
    engines.Loop/Vmap/LMEngine      — how teachers train and vote
    codec                           — PartyUpdate <-> bytes, frames
                                      byte-identical to the reference's
    transport.{InProcess,Thread,Subprocess}Transport
                                    — where parties run, how the ONE
                                      message crosses the silo boundary
                                      (always through the codec)
    net.SocketTransport             — the fleet: updates over real TCP,
                                      streamed into the running vote
                                      aggregate, deadline/quorum
                                      straggler semantics, crash
                                      recovery via the journal
    journal.RoundJournal            — fsync'd write-ahead log of
                                      accepted frames (the reference's
                                      file format)
    faults.FaultPlan / ChaosProxy   — seeded fault injection (the
                                      reference's plans from a seed)
    aggregate.StreamingVoteAggregate— the server's running vote fold
    domain.VoteDomain               — the typed vote layout
    strategies.*                    — every compared algorithm, one shape
"""
from repro_torch.federation import codec  # noqa: F401
from repro_torch.federation.aggregate import (  # noqa: F401
    StreamingVoteAggregate)
from repro_torch.federation.bindings import (  # noqa: F401
    PartyBinding, ResolvedBinding, learner_kind, register_learner_kind,
    registered_learner_kinds)
from repro_torch.federation.domain import (VoteDomain,  # noqa: F401
                                           example_domain,
                                           fingerprint_queries,
                                           learner_domain, token_domain)
from repro_torch.federation.engines import (Engine,  # noqa: F401
                                            LMEngine, LoopEngine,
                                            VmapEngine, get_engine)
from repro_torch.federation.messages import (PartyUpdate,  # noqa: F401
                                             RoundResult, ShapeDtype,
                                             TokenLabels, label_wire_bytes,
                                             pytree_bytes)
from repro_torch.federation.faults import (ChaosProxy, Fault,  # noqa: F401
                                           FaultPlan)
from repro_torch.federation.journal import (JournalError,  # noqa: F401
                                            JournalExistsError,
                                            RoundJournal)
from repro_torch.federation.net import (Coordinator,  # noqa: F401
                                        QuorumError, SocketTransport,
                                        UpdateRefused, run_party_client)
from repro_torch.federation.party import Party, query_budget  # noqa: F401
from repro_torch.federation.server import Server  # noqa: F401
from repro_torch.federation.session import (FedKTSession,  # noqa: F401
                                            party_starting_keys)
from repro_torch.federation.strategies import (  # noqa: F401
    CentralPATEStrategy, FedKTStrategy, IterativeStrategy, SoloStrategy,
    Strategy, StrategyResult)
from repro_torch.federation.transport import (  # noqa: F401
    InProcessTransport, SubprocessTransport, ThreadTransport, Transport,
    TransportBase, get_transport)
