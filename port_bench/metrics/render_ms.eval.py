"""Host ms an eval step in FakeNav's renderer (``env.render``,
``envs/fake_nav.py::FakeNavSim.render_at``, numpy), over the steps
(``eval.policy`` calls); a step that ends an episode renders twice."""

from port_bench import program_spans


def read(reading, ctx):
    return program_spans.per(ctx, ["env.render"], "host_s", "eval.policy",
                             1e3)
