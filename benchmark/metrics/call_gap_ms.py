"""Device ms between one pool call's last replay and the next call's
first (each call's span on the device, from the previous call's end
event, less its replays: ``EpochStep.last_run["events"]``), the mean
over the window's calls: what the re-capture, the release and the next
pool's draw cost the device a call."""


def read(ctx):
    calls = [c for c in ctx.calls if "device_ms" in c]
    if not calls:
        return None
    return sum(c["device_ms"] - c["replays_ms"] for c in calls) / len(calls)
