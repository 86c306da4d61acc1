"""The frozen yardstick of the kernels' rooflines: the work each kernel's
function needs, counted from the problem's sizes alone, and the card's
published peaks.  A change to how a kernel computes leaves these numbers
as they are."""
