"""Host ms a step in the env (``envs/*``, ``train/evaluate.py``'s
loop): the env step's span less the encoder calls inside it."""

def read(reading, ctx):
    env = reading.host.get("env_step")
    if not env:
        return None
    encoder = sum(reading.host.get("encoder", []))
    return (sum(env) - encoder) / len(env) * 1e3
