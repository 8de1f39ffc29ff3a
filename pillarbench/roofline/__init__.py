"""The yardstick's arithmetic: published peaks, the model's operations and
each hand-written kernel's bytes and operations, as functions of a call's
shapes."""
