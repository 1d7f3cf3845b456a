"""solver.host_reads: the program's pt_read spans (one a wait of the host
for the card: a read back, a blocking copy to the card, a torch.linalg
check; core/linalg.py host_read) inside its pt_eigsh span, a traced call;
equals eigsh's stats["num_host_reads"]; moves job_s."""

from lib import spans


def read(run):
    return spans.count_in(run, "pt_read", "pt_eigsh")
