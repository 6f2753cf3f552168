"""LM driver and step solver: host reads a traced solve, the mean over the
traced solves of the change of the program's ``utils.profiling.COUNTERS
["host_reads"]`` over each (every device value a solve waits for on the
host: the LM loop's reads, each CG flag, the launch plans' own reads). None
for a program that keeps no such counter."""


def read(ctx):
    solves = ctx.run["solves"]
    if not solves or any("host_reads" not in s for s in solves):
        return None
    return sum(s["host_reads"] for s in solves) / len(solves)
