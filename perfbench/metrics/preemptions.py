"""preemptions: running requests the engine preempted for want of pages
(``ServingEngine.preemptions``) over the whole window."""


def read(run):
    return run.counts.get("preemptions")
