"""The program's prep of a session, in s: ``CountResult.prep_seconds``
(it ends in a device sync); the mean over the sessions where the mix
builds one a call."""


def read(run):
    if not run.prep_s:
        return None
    return sum(run.prep_s) / len(run.prep_s)
