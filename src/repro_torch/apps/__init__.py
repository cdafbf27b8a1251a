from repro_torch.apps.tcmm import MicroClusterState, MicroClusterJob, MacroClusterJob
