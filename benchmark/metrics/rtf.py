"""Real-time factor: the audio seconds of every request answered, over
all the time from the window's start until the last answer (the window,
then the requests in flight when it closed)."""

UNIT = "audio_s/s"


def read(run):
    done = [r for r in run.records if r.ok]
    if not done:
        return None
    return sum(r.req.seconds for r in done) / max(r.done for r in done)
