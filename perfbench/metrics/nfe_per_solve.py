"""Right-hand-side evaluations per solve (ode/integrate.odeint's
``OdeSolution.nfe``), the mean over the window's solves."""


def read(ctx):
    nfe = ctx.state.window["nfe"]
    return sum(nfe) / len(nfe) if nfe else None
